"""Self-attention over a contiguous or paged, possibly sub-byte KV cache
(counterpart of ``repro/models/attention.py``).

Projections are quantizable Dense layers (the paper's technique applies to
them).  The cache stores K/V at ``cfg.quant.kv_bits`` precision: bf16 (0 or
16), int8 with per-(pos, kv-head) bf16 scales (8), or bit-dense int32 words
along head_dim with the same scale planes (4 / 2).

Writes happen in place: each layer's cache tensors are allocated once
(:func:`init_kv_cache`, or :func:`init_paged_kv_cache` for a page pool read
through block tables) and updated with ``index_put_`` -- the counterpart
of the reference's donated cache buffers.  Every read goes through the
fused flash-decoding kernels (kernels/ulppack_attention.py: K3 over a
contiguous cache, K4 over a paged one), for decode steps, chunked-prefill
windows and cache-free forwards alike.

Ported here: the vector-indexed, non-windowed path, contiguous and paged.
Sliding-window rings, cross-attention and M-RoPE wait for a later slice
(ROADMAP.md Queue 1 item 13); the legacy gather read
(``_paged_cache_read``) waits with ``_chunked_attention`` (item 8c).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
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


def ragged_write_indices(cache_index: torch.Tensor, cache_valid: torch.Tensor,
                         sq: int, size: int):
    """(row, token, slot) index tensors of a ragged window write: token j of
    row b lands at slot ``cache_index[b] + j`` when ``j < cache_valid[b]``
    and the slot lies inside the cache; every other token is dropped, as
    the reference's ``mode='drop'`` scatter drops it.  Computed on the
    indices' own device (the serving steps pass host tensors, so the
    ``nonzero`` never waits on the card)."""
    offs = torch.arange(sq, dtype=torch.int32, device=cache_index.device)
    wpos = cache_index[:, None] + offs[None, :]
    keep = (offs[None, :] < cache_valid[:, None]) & (wpos < size) & (wpos >= 0)
    bi, ti = keep.nonzero(as_tuple=True)
    return bi, ti, wpos[bi, ti].to(torch.int64)


def _offsets(cache_index, cache_valid, b: int, sq: int):
    """Per-row write offsets [B] and valid counts [B] of a [B, sq] window,
    where ``cache_index`` lives: a scalar offset is shared by every row,
    and ``cache_valid=None`` means every token is valid."""
    idx = torch.as_tensor(cache_index, dtype=torch.int32)
    if idx.dim() == 0:
        idx = idx.expand(b)
    vlen = (torch.full((b,), sq, dtype=torch.int32, device=idx.device)
            if cache_valid is None
            else torch.as_tensor(cache_valid, dtype=torch.int32,
                                 device=idx.device))
    return idx, vlen


def ragged_window(cache_index, cache_valid, b: int, sq: int, size: int,
                  device):
    """Per-row write offsets [B], valid counts [B] and the ragged write
    indices of a [B, sq] window, all on ``device``.  The indices are worked
    out where ``cache_index`` lives, so host-side offsets (the serving
    steps') cost the card no wait."""
    idx, vlen = _offsets(cache_index, cache_valid, b, sq)
    write = ragged_write_indices(idx, vlen, sq, size)
    return (idx.to(device), vlen.to(device),
            tuple(t.to(device) for t in write))


def paged_write_indices(cache_index: torch.Tensor, cache_valid: torch.Tensor,
                        block_tables: torch.Tensor, sq: int, page_size: int,
                        num_pages: int):
    """(row, token, page, page-row) index tensors of a block-table write:
    token j of row b is at logical position ``p = cache_index[b] + j`` and
    lands at physical page ``block_tables[b, p // page_size]`` (the page
    index clipped to the table, as the reference clips it), row
    ``p % page_size``.  Tokens with ``j >= cache_valid[b]`` are dropped, as
    the reference's ``mode='drop'`` scatter drops them, and so are table
    entries outside the pool."""
    bt = torch.as_tensor(block_tables, dtype=torch.int64,
                         device=cache_index.device)
    offs = torch.arange(sq, dtype=torch.int64, device=cache_index.device)
    wpos = cache_index[:, None].to(torch.int64) + offs[None, :]
    keep = offs[None, :] < cache_valid[:, None]
    bi, ti = keep.nonzero(as_tuple=True)
    pos = wpos[bi, ti]
    pages = bt[bi, torch.clamp(pos // page_size, 0, bt.shape[1] - 1)]
    inside = (pages >= 0) & (pages < num_pages)
    return (bi[inside], ti[inside], pages[inside],
            (pos % page_size)[inside])


def paged_window(cache_index, cache_valid, block_tables, b: int, sq: int,
                 page_size: int, num_pages: int, device):
    """As :func:`ragged_window` for a paged pool: offsets [B], valid counts
    [B], the block-table write indices (worked out where ``cache_index``
    lives) and the block table, all on ``device``."""
    idx, vlen = _offsets(cache_index, cache_valid, b, sq)
    bt = torch.as_tensor(block_tables, dtype=torch.int32)
    write = paged_write_indices(idx, vlen, bt, sq, page_size, num_pages)
    return (idx.to(device), vlen.to(device),
            tuple(t.to(device) for t in write), bt.to(device))


def _store(cache, index, kk, vv, kv_bits):
    """Quantize (and for sub-byte ``kv_bits`` word-pack) the token rows
    ``kk`` / ``vv`` when the cache is quantized, then put them at
    ``index`` in every leaf, in place."""
    if "k_scale" in cache:
        qk, sk = kv_quantize(kk, kv_bits)
        qv, sv = kv_quantize(vv, kv_bits)
        vals = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        vals = {"k": kk, "v": vv}
    for name, val in vals.items():
        buf = cache[name]
        buf.index_put_(index, val.to(buf.dtype))
    return cache


def cache_write_ragged(cache, k, v, write, kv_bits=0):
    """In-place ragged write of [B, s, KVH, hd] float K/V through
    ``write = (row, token, slot)`` (:func:`ragged_write_indices`),
    quantizing -- and for sub-byte ``kv_bits`` word-packing -- first when
    the cache is quantized."""
    bi, ti, slots = write
    return _store(cache, (bi, slots), k[bi, ti], v[bi, ti], kv_bits)


def cache_write_paged(cache, k, v, write, kv_bits=0):
    """In-place block-table write of [B, s, KVH, hd] float K/V through
    ``write = (row, token, page, page-row)`` (:func:`paged_write_indices`):
    the counterpart of the reference's ``_cache_write_paged``, quantized
    per token row, so the stored words and scale planes equal the unpaged
    layout's at the same positions."""
    bi, ti, pages, rows = write
    return _store(cache, (pages, rows), k[bi, ti], v[bi, ti], kv_bits)


def attention_apply(p, cfg, x, *, positions, quant_mode="none", cache=None,
                    cache_index=None, cache_valid=None, write=None,
                    block_tables=None, backend="auto"):
    """Attention forward; returns (out, cache).

      * cache=None: causal self-attention over the window's own K/V.
      * cache + cache_index ([B] per-row write offsets, or a scalar shared
        by every row): the window's K/V is written into the cache in place
        -- tokens past ``cache_valid[b]`` dropped -- and the query reads the
        stored cache with ``valid_len = cache_index + cache_valid``.
        ``write`` may carry the window's precomputed indices; the offsets
        and counts must then be device tensors (:func:`ragged_window`).
      * paged: ``block_tables`` [B, n_pages] int32 maps each row's logical
        page j to a physical page of a pool (:func:`init_paged_kv_cache`).
        Writes land through the table (:func:`paged_window` /
        :func:`cache_write_paged`; ``write`` then carries its four index
        tensors and ``block_tables`` must be the device table) and the
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

    if cache is None:
        full = torch.full((b,), sq, dtype=torch.int32, device=x.device)
        out = ulppack_attention.fused_decode_attention(
            q, {"k": k, "v": v}, full, positions, kv_bits=0, hd=hd,
            backend=backend)
    else:
        if cache_index is None:
            raise NotImplementedError(
                "filling a cache without write offsets (the reference's "
                "fake-quant prefill step) is still to be ported; pass "
                "cache_index")
        kv_bits = cfg.quant.kv_bits
        if block_tables is None:
            if write is None:
                cache_index, cache_valid, write = ragged_window(
                    cache_index, cache_valid, b, sq, cache["k"].shape[1],
                    x.device)
            cache_write_ragged(cache, k, v, write, kv_bits)
        else:
            if write is None:
                cache_index, cache_valid, write, block_tables = paged_window(
                    cache_index, cache_valid, block_tables, b, sq,
                    cache["k"].shape[1], cache["k"].shape[0], x.device)
            cache_write_paged(cache, k, v, write, kv_bits)
        valid_len = cache_index + cache_valid
        out = ulppack_attention.fused_decode_attention(
            q, cache, valid_len, positions, kv_bits=kv_bits, hd=hd,
            block_tables=block_tables, backend=backend)
    out = dense_apply(p["o"], out.reshape(b, sq, cfg.num_heads * hd), **qm)
    return out, cache
