"""Self-attention over a contiguous or paged, possibly sub-byte KV cache
(counterpart of ``repro/models/attention.py``).

Projections are quantizable Dense layers (the paper's technique applies to
them).  The cache stores K/V at ``cfg.quant.kv_bits`` precision: bf16 (0 or
16), int8 with per-(pos, kv-head) bf16 scales (8), or bit-dense int32 words
along head_dim with the same scale planes (4 / 2).

Writes happen in place: each layer's cache tensors are allocated once
(:func:`init_kv_cache`, or :func:`init_paged_kv_cache` for a page pool read
through block tables) and written through fixed-shape destination rows
(:func:`cache_write`, the predicated row scatter of
kernels/cache_write.py) -- the counterpart of the reference's donated
cache buffers, and capturable in a CUDA graph.  Every serving read goes
through the fused flash-decoding kernels (kernels/ulppack_attention.py: K3
over a contiguous cache, K4 over a paged one), for decode steps,
chunked-prefill windows and cache-free forwards alike.

Training forwards (``quant_mode='qat'``, or any forward autograd records)
and the fake-quant prefill that fills a fresh cache without write offsets
take :func:`chunked_attention` instead: the reference's q-chunked exact
softmax in plain differentiable ops (f32 accumulation, per-chunk
recomputation in the backward), since K3 has no gradient.

Ported here: the vector-indexed, non-windowed path, contiguous and paged.
Sliding-window rings, cross-attention and M-RoPE wait for a later slice
(ROADMAP.md Queue 1 item 13); the legacy gather read
(``_paged_cache_read``, ``_cache_read``) waits for item 8c.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.core import packing
from repro_torch.kernels import autotune
from repro_torch.kernels import cache_write as cache_write_lib
from repro_torch.kernels import ulppack_attention
from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init


def check_supported(cfg):
    """Raise for attention flavours this slice does not serve."""
    missing = []
    if cfg.sliding_window:
        missing.append("sliding-window ring caches")
    if cfg.mrope:
        missing.append("M-RoPE")
    if cfg.is_encoder_decoder:
        missing.append("cross-attention (encoder-decoder)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are still to be ported "
            f"(ROADMAP.md Queue 1 item 13)")


def attention_init(generator, cfg, *, dtype=torch.float32, device="cpu"):
    hd = cfg.resolved_head_dim
    kw = dict(dtype=dtype, quantized=True, qcfg=cfg.quant, device=device)
    return {
        "q": dense_init(generator, cfg.d_model, cfg.num_heads * hd,
                        use_bias=cfg.qkv_bias, **kw),
        "k": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd,
                        use_bias=cfg.qkv_bias, **kw),
        "v": dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd,
                        use_bias=cfg.qkv_bias, **kw),
        "o": dense_init(generator, cfg.num_heads * hd, cfg.d_model,
                        scale=1.0 / (cfg.num_heads * hd) ** 0.5, **kw),
    }


def _cache_leaves(cfg, lead, dtype, device):
    """Zeroed cache leaves with leading dims ``lead`` for ``kv_bits``."""
    hd = cfg.resolved_head_dim
    bits = cfg.quant.kv_bits
    shape = tuple(lead) + (cfg.num_kv_heads,)

    def zeros(last, dt):
        return torch.zeros(shape + last, dtype=dt, device=device)

    if bits == 8:
        return {"k": zeros((hd,), torch.int8), "v": zeros((hd,), torch.int8),
                "k_scale": zeros((), torch.bfloat16),
                "v_scale": zeros((), torch.bfloat16)}
    if bits in (4, 2):
        hd_words = -(-hd // (32 // bits))
        return {"k": zeros((hd_words,), torch.int32),
                "v": zeros((hd_words,), torch.int32),
                "k_scale": zeros((), torch.bfloat16),
                "v_scale": zeros((), torch.bfloat16)}
    if bits not in (0, 16):
        raise ValueError(f"unsupported kv_bits {bits}; expected 0/16/8/4/2")
    return {"k": zeros((hd,), dtype), "v": zeros((hd,), dtype)}


def init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """Contiguous KV cache [batch, max_len, KVH, ...] for ``kv_bits``:
      0 / 16 -- ``dtype`` (bf16 in serving).
      8      -- int8 values + per-(pos, kv-head) bf16 absmax scales.
      4 / 2  -- int32 words (``packing.pack_words`` along head_dim,
                ``32 // kv_bits`` values per word) + the same scales.
    """
    check_supported(cfg)
    return _cache_leaves(cfg, (batch, max_len), dtype, device)


def init_paged_kv_cache(cfg, num_pages, page_size, dtype=torch.bfloat16,
                        device="cpu"):
    """Paged KV pool: ``num_pages`` pages of ``page_size`` token rows.

    The same per-row layouts as :func:`init_kv_cache` with the leading
    ``[B, S]`` replaced by ``[P, page_size]``; one page-id space serves
    every attention layer (serve/pages.py).  Sub-byte layouts need
    ``page_size`` to be a multiple of the word-packing tail
    (serve/pages.validate_page_size).  Sliding-window rings stay unpaged."""
    if cfg.sliding_window:
        raise ValueError(
            "paged KV cache does not support sliding-window ring caches; "
            "serve sliding-window archs unpaged")
    check_supported(cfg)
    return _cache_leaves(cfg, (num_pages, page_size), dtype, device)


def kv_quantize(x: torch.Tensor, bits: int = 8):
    """[..., hd] float -> (stored lattice, bf16 per-row scales).

    bits == 8: signed int8 absmax.  bits in (4, 2): midpoint-zero-point
    unsigned lattice (scale targets ``qmax - zp`` steps) packed bit-dense
    along head_dim into int32 words.  The 1e-8 floor keeps all-zero rows
    NaN-free."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    if bits == 8:
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale.to(torch.bfloat16)
    zp = 1 << (bits - 1)
    qmax = (1 << bits) - 1
    scale = torch.clamp(amax / (qmax - zp), min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]) + zp, 0, qmax)
    return (packing.pack_words(q.to(torch.int32), bits, axis=-1),
            scale.to(torch.bfloat16))


def ragged_dest_rows(cache_index: torch.Tensor, cache_valid: torch.Tensor,
                     sq: int, size: int) -> torch.Tensor:
    """[B * sq] int64 destination rows of a ragged window write into a
    contiguous cache of ``size`` slots a row: token j of row b lands at flat
    row ``b * size + cache_index[b] + j`` when ``j < cache_valid[b]`` and
    the slot lies inside the cache; every other token gets -1 and is
    dropped, as the reference's ``mode='drop'`` scatter drops it.  Fixed
    shape, computed on the offsets' device (no host sync), so a CUDA graph
    can capture it."""
    dev = cache_index.device
    offs = torch.arange(sq, dtype=torch.int64, device=dev)
    wpos = cache_index[:, None].to(torch.int64) + offs[None, :]
    keep = (offs[None, :] < cache_valid[:, None]) & (wpos < size) & (wpos >= 0)
    rows = torch.arange(cache_index.shape[0], dtype=torch.int64,
                        device=dev)[:, None] * size + wpos
    return torch.where(keep, rows, -1).reshape(-1)


def paged_dest_rows(cache_index: torch.Tensor, cache_valid: torch.Tensor,
                    block_tables: torch.Tensor, sq: int, page_size: int,
                    num_pages: int) -> torch.Tensor:
    """[B * sq] int64 destination rows of a block-table write: token j of
    row b is at logical position ``p = cache_index[b] + j`` and lands at
    flat pool row ``page * page_size + p % page_size`` of physical page
    ``page = block_tables[b, p // page_size]`` (the page index clipped to
    the table, as the reference clips it).  Tokens with ``j >=
    cache_valid[b]``, and table entries outside the pool, get -1 and are
    dropped, as the reference's ``mode='drop'`` scatter drops them.  Fixed
    shape, computed on the offsets' device."""
    bt = block_tables.to(torch.int64)
    offs = torch.arange(sq, dtype=torch.int64, device=cache_index.device)
    pos = cache_index[:, None].to(torch.int64) + offs[None, :]
    pages = torch.gather(bt, 1, torch.clamp(pos // page_size, 0,
                                            bt.shape[1] - 1))
    keep = (offs[None, :] < cache_valid[:, None]) & (pages >= 0) \
        & (pages < num_pages)
    return torch.where(keep, pages * page_size + pos % page_size,
                       -1).reshape(-1)


def window(cache_index, cache_valid, block_tables, b: int, sq: int,
           cache_shape, device):
    """Per-row write offsets [B] int32, valid counts [B] int32, the
    destination rows [B * sq] int64 of a [B, sq] window and the block
    table (int32, or None for a contiguous cache), all on ``device``.  A
    scalar ``cache_index`` is shared by every row; ``cache_valid=None``
    means every token is valid.  ``cache_shape`` is a cache leaf's shape
    ([B, S, ...], or [P, page_size, ...] with a block table)."""
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
    if idx.dim() == 0:
        idx = idx.expand(b)
    vlen = (torch.full((b,), sq, dtype=torch.int32, device=device)
            if cache_valid is None
            else torch.as_tensor(cache_valid, dtype=torch.int32,
                                 device=device))
    if block_tables is None:
        return idx, vlen, ragged_dest_rows(idx, vlen, sq, cache_shape[1]), None
    bt = torch.as_tensor(block_tables, dtype=torch.int32, device=device)
    dest = paged_dest_rows(idx, vlen, bt, sq, cache_shape[1], cache_shape[0])
    return idx, vlen, dest, bt


def cache_write(cache, k, v, dest, kv_bits=0, *, backend="auto"):
    """In-place window write of [B, s, KVH, hd] float K/V through ``dest``
    (:func:`ragged_dest_rows` or :func:`paged_dest_rows`): the whole window
    is quantized -- and for sub-byte ``kv_bits`` word-packed -- per token
    row when the cache is quantized, then every kept token's row is put at
    its destination in every leaf (``kernels/cache_write.py``: the kernel
    on the card, ``nonzero`` + ``index_put_`` on the CPU).  Quantization is
    per row, so the stored words and scale planes equal the reference's
    (``_cache_write_ragged`` / ``_cache_write_paged``) and, paged, the
    unpaged layout's at the same positions."""
    if "k_scale" in cache:
        qk, sk = kv_quantize(k, kv_bits)
        qv, sv = kv_quantize(v, kv_bits)
        vals = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        vals = {"k": k, "v": v}
    leaves = [(cache[name].flatten(0, 1),
               val.to(cache[name].dtype).flatten(0, 1))
              for name, val in vals.items()]
    cache_write_lib.cache_write(dest, leaves, backend=backend)
    return cache


NEG_INF = -1e30
Q_CHUNK = 512     # the reference's q-chunk when its tuning cache misses


def chunked_attention(q, k, v, mask_fn, q_positions, chunk: int = Q_CHUNK):
    """Exact softmax attention, q-chunked to bound the score buffer (the
    reference's ``_chunked_attention`` over raw K/V).

    q: [B, Sq, H, hd]; k, v: [B, Sk, KVH, hd]; ``mask_fn(qpos [B, C])`` ->
    [B, C, Sk] boolean validity.  The scores and the value product take
    the operands in q's dtype (the reference's ``opd``) and accumulate in
    f32: bf16 operands are widened first, which is exact.  Where ``Sq >
    chunk`` each full chunk runs under ``torch.utils.checkpoint``, so the
    backward recomputes its [C, Sk] scores instead of storing them.  The
    forward runs in an ``attention`` profiler range.  Returns [B, Sq, H,
    hd] in q's dtype."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    opd = q.dtype
    kvh = k.shape[2]
    groups = h // kvh
    k32 = k.to(opd).to(torch.float32)
    v32 = v.to(opd).to(torch.float32)

    def one_chunk(qc, qpos):
        c = qc.shape[1]
        qg = (qc.to(torch.float32) * scale).to(opd)
        qg = qg.reshape(b, c, kvh, groups, hd).to(torch.float32)
        scores = torch.einsum("bckgd,bskd->bckgs", qg, k32)
        valid = mask_fn(qpos)[:, :, None, None, :]
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bckgs,bskd->bckgd",
                           probs.to(opd).to(torch.float32), v32)
        return out.reshape(b, c, h, hd)

    with torch.profiler.record_function("attention"):
        if sq <= chunk:
            return one_chunk(q, q_positions).to(q.dtype)
        outs = []
        for s0 in range(0, sq, chunk):
            qc, qpos = q[:, s0:s0 + chunk], q_positions[:, s0:s0 + chunk]
            if qc.shape[1] == chunk:
                outs.append(torch_checkpoint.checkpoint(
                    one_chunk, qc, qpos, use_reentrant=False))
            else:                   # the tail, as the reference runs it
                outs.append(one_chunk(qc, qpos))
        return torch.cat(outs, dim=1).to(q.dtype)


def _causal(positions, sk):
    """The training mask: key position <= query position."""
    def mask_fn(qpos):
        return positions[:, None, :sk] <= qpos[:, :, None]
    return mask_fn


def attention_apply(p, cfg, x, *, positions, quant_mode="none", cache=None,
                    cache_index=None, cache_valid=None, dest=None,
                    block_tables=None, backend="auto"):
    """Attention forward; returns (out, cache).

      * cache=None: causal self-attention over the window's own K/V --
        through K3 when serving, through :func:`chunked_attention` in a
        training forward (``quant_mode='qat'``, or autograd recording).
      * cache without cache_index: the prefill of a fresh contiguous
        cache -- the window's K/V fill rows 0 .. s-1 (:func:`cache_write`)
        and the query attends over the raw window
        (:func:`chunked_attention`), as the reference's fake-quant prefill
        step does.
      * cache + cache_index ([B] per-row write offsets, or a scalar shared
        by every row): the window's K/V is written into the cache in place
        -- tokens past ``cache_valid[b]`` dropped -- and the query reads the
        stored cache with ``valid_len = cache_index + cache_valid``.
        ``dest`` may carry the window's precomputed destination rows; the
        offsets, counts and table must then be device tensors
        (:func:`window`).
      * paged: ``block_tables`` [B, n_pages] int32 maps each row's logical
        page j to a physical page of a pool (:func:`init_paged_kv_cache`).
        Writes land through the table (:func:`paged_dest_rows`) and the
        read walks the pool through the table (K4), so the gathered view
        never materializes.
    """
    check_supported(cfg)
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    q = dense_apply(p["q"], x, **qm).reshape(b, sq, cfg.num_heads, hd)
    k = dense_apply(p["k"], x, **qm).reshape(b, sq, cfg.num_kv_heads, hd)
    v = dense_apply(p["v"], x, **qm).reshape(b, sq, cfg.num_kv_heads, hd)
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, sq)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)

    train = quant_mode == "qat" or (torch.is_grad_enabled()
                                     and q.requires_grad)
    if cache is None or cache_index is None:
        # the q-chunk of chunked_attention: the tuned one for this
        # signature, Q_CHUNK on a miss (the reference's
        # _attention_epilogue does the same lookup)
        chunk = autotune.attention_chunk_for(
            b, sq, sq, cfg.num_heads, cfg.num_kv_heads, hd,
            int(cfg.quant.kv_bits))
    if cache is not None and cache_index is None:
        # the fake-quant prefill: the window fills rows 0 .. sq-1 of a
        # fresh cache, and the query attends over the raw window
        _, _, rows, _ = window(0, None, None, b, sq, cache["k"].shape,
                               x.device)
        cache_write(cache, k.detach(), v.detach(), rows, cfg.quant.kv_bits,
                    backend=backend)
        out = chunked_attention(q, k, v, _causal(positions, sq), positions,
                                chunk)
    elif cache is None and train:
        out = chunked_attention(q, k, v, _causal(positions, sq), positions,
                                chunk)
    elif cache is None:
        full = torch.full((b,), sq, dtype=torch.int32, device=x.device)
        out = ulppack_attention.fused_decode_attention(
            q, {"k": k, "v": v}, full, positions, kv_bits=0, hd=hd,
            backend=backend)
    else:
        kv_bits = cfg.quant.kv_bits
        if dest is None:
            cache_index, cache_valid, dest, block_tables = window(
                cache_index, cache_valid, block_tables, b, sq,
                cache["k"].shape, x.device)
        cache_write(cache, k, v, dest, kv_bits, backend=backend)
        valid_len = cache_index + cache_valid
        out = ulppack_attention.fused_decode_attention(
            q, cache, valid_len, positions, kv_bits=kv_bits, hd=hd,
            block_tables=block_tables, backend=backend)
    out = dense_apply(p["o"], out.reshape(b, sq, cfg.num_heads * hd), **qm)
    return out, cache
