"""Attention over a contiguous or paged, possibly sub-byte KV cache, with
RoPE or M-RoPE, a non-causal mode and cross-attention (counterpart of
``repro/models/attention.py``).

Projections are quantizable Dense layers (the paper's technique applies to
them).  The cache stores K/V at ``cfg.quant.kv_bits`` precision: bf16 (0 or
16), int8 with per-(pos, kv-head) bf16 scales (8), or bit-dense int32 words
along head_dim with the same scale planes (4 / 2).  Sliding-window configs
keep a ring of ``min(max_len, window)`` slots: position p lives at slot
``p % size``.

Writes happen in place: each layer's cache tensors are allocated once
(:func:`init_kv_cache`, or :func:`init_paged_kv_cache` for a page pool read
through block tables) and written through fixed-shape destination rows
(:func:`cache_write`, the predicated row scatter of
kernels/cache_write.py) -- the counterpart of the reference's donated
cache buffers, and capturable in a CUDA graph.

Reads of a written cache take one of two paths, chosen as the reference's
``_use_fused_decode`` chooses (:func:`use_fused_decode`):
  * the fused flash-decoding kernels (kernels/ulppack_attention.py: K3
    over a contiguous cache, K4 over a paged one) for a non-windowed cache
    read with per-row offsets, or by a single lockstep token;
  * the legacy read otherwise -- sliding-window rings, a scalar (lockstep)
    offset with more than one token, or ``REPRO_FUSED_DECODE=0``: the
    stored cache is dequantized (paged: gathered through the block table)
    inside each q-chunk of :func:`chunked_attention`, under the ring-
    position mask (:func:`ring_positions`, :func:`ring_positions_batch`).
    The reference computes this path in XLA, without a Pallas kernel, so
    plain PyTorch is its port.

Cache-free serving forwards go through K3 too, unless the config is
windowed (K3 has no window) or the kill-switch is set: causal, or with
every key admitted (the encoder's non-causal self-attention, and
cross-attention over an encoder's K/V, :func:`precompute_cross_kv`) by
giving every query the last key's position.  Training forwards
(``quant_mode='qat'``, or any forward autograd records) and the fake-quant
prefill that fills a fresh cache take :func:`chunked_attention` over the
raw K/V: the reference's q-chunked exact softmax in plain differentiable
ops (f32 accumulation, per-chunk recomputation in the backward), since K3
has no gradient.

Self-attention rotates q and k by RoPE at ``positions`` or, for an M-RoPE
config given ``positions3`` [3, B, S] (t, h, w ids), by
``common.apply_mrope``; ``positions`` stays what the mask, the cache rows
and K3's query positions read.  Cross-attention rotates neither.
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
from repro_torch.parallel import sharding


def cache_size(cfg, max_len: int) -> int:
    """Slots a contiguous cache row holds: the ring's ``min(max_len,
    window)`` for sliding-window configs, else ``max_len``."""
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


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
    """Contiguous KV cache [batch, size, KVH, ...] for ``kv_bits``, ``size``
    = :func:`cache_size` (the ring of a sliding-window config):
      0 / 16 -- ``dtype`` (bf16 in serving).
      8      -- int8 values + per-(pos, kv-head) bf16 absmax scales.
      4 / 2  -- int32 words (``packing.pack_words`` along head_dim,
                ``32 // kv_bits`` values per word) + the same scales.
    """
    return _cache_leaves(cfg, (batch, cache_size(cfg, max_len)), dtype,
                         device)


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
                     sq: int, size: int, ring: bool = False) -> torch.Tensor:
    """[B * sq] int64 destination rows of a ragged window write into a
    contiguous cache of ``size`` slots a row: token j of row b is at
    position ``p = cache_index[b] + j`` and lands at flat row ``b * size +
    slot``, ``slot = p % size`` in a ring (``ring``), else ``p``, when ``j
    < cache_valid[b]`` and the slot lies inside the cache; every other
    token gets -1 and is dropped, as the reference's ``mode='drop'``
    scatter drops it.  Fixed shape, computed on the offsets' device (no
    host sync), so a CUDA graph can capture it."""
    dev = cache_index.device
    offs = torch.arange(sq, dtype=torch.int64, device=dev)
    wpos = cache_index[:, None].to(torch.int64) + offs[None, :]
    slot = wpos % size if ring else wpos
    keep = (offs[None, :] < cache_valid[:, None]) & (slot < size) \
        & (wpos >= 0)
    rows = torch.arange(cache_index.shape[0], dtype=torch.int64,
                        device=dev)[:, None] * size + slot
    return torch.where(keep, rows, -1).reshape(-1)


def lockstep_dest_rows(cache_index: torch.Tensor, b: int, sq: int,
                       size: int, ring: bool = False) -> torch.Tensor:
    """[B * sq] int64 destination rows of a lockstep write (one scalar
    offset for every row, every token written): where the reference's
    ``_cache_write`` puts its ``dynamic_update_slice`` -- the window starts
    at slot ``cache_index % size`` in a ring, else at ``cache_index``, and
    a start that would overrun the cache is clamped to ``size - sq``, as
    ``dynamic_update_slice`` clamps it."""
    if sq > size:
        raise ValueError(f"a lockstep window of {sq} tokens does not fit a "
                         f"cache of {size} slots")
    dev = cache_index.device
    start = cache_index.to(torch.int64)
    start = torch.clamp(start % size if ring else start, 0, size - sq)
    offs = torch.arange(sq, dtype=torch.int64, device=dev)
    rows = torch.arange(b, dtype=torch.int64, device=dev)[:, None] * size
    return (rows + start + offs[None, :]).reshape(-1)


def prefill_dest_rows(b: int, sq: int, size: int, ring: bool,
                      device) -> torch.Tensor:
    """[B * sq] int64 destination rows of the fresh-cache prefill (tokens
    at positions 0 .. sq-1).  A ring keeps the last ``size`` tokens, token
    j at slot ``j % size``: the reference's write of them at slot 0 rolled
    by ``sq % size`` (its ``:479-486``) puts them there.  Otherwise the
    window fills rows 0 .. sq-1 (tokens past the cache are dropped)."""
    j = torch.arange(sq, dtype=torch.int64, device=device)
    keep = j >= sq - size if ring else j < size
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None] * size \
        + (j % size)[None, :]
    return torch.where(keep[None, :], rows, -1).reshape(-1)


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
           cache_shape, device, *, sliding_window: int = 0):
    """Write offsets, valid counts [B] int32, the destination rows [B * sq]
    int64 of a [B, sq] window and the block table (int32, or None for a
    contiguous cache), all on ``device``.  ``cache_valid=None`` means every
    token is valid.  ``cache_shape`` is a cache leaf's shape ([B, S, ...],
    or [P, page_size, ...] with a block table); ``sliding_window`` (the
    config's) makes a contiguous cache a ring.

    A [B] ``cache_index`` gives each row its own offset.  A scalar one is
    the reference's lockstep path: it stays a 0-d tensor, every row writes
    its whole window where the reference's ``dynamic_update_slice`` would
    (:func:`lockstep_dest_rows`; ``cache_valid`` is ignored, as there), and
    the valid counts are ``sq``."""
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
    if idx.dim() == 0:
        if block_tables is not None:
            raise NotImplementedError(
                "paged decode is vector-indexed (per-slot positions); pass "
                "cache_index as a [B] array")
        vlen = torch.full((b,), sq, dtype=torch.int32, device=device)
        return idx, vlen, lockstep_dest_rows(idx, b, sq, cache_shape[1],
                                             bool(sliding_window)), None
    vlen = (torch.full((b,), sq, dtype=torch.int32, device=device)
            if cache_valid is None
            else torch.as_tensor(cache_valid, dtype=torch.int32,
                                 device=device))
    if block_tables is None:
        return idx, vlen, ragged_dest_rows(idx, vlen, sq, cache_shape[1],
                                           bool(sliding_window)), None
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


def kv_dequantize(q, scale, dtype=torch.float32, bits: int = 8,
                  hd: int | None = None):
    """Stored lattice + per-row scales -> [..., hd] values in ``dtype``,
    computed in ``dtype`` as the reference's ``_kv_dequantize`` does (the
    lattice values are exact in bf16)."""
    if bits == 8:
        return q.to(dtype) * scale.to(dtype)[..., None]
    zp = 1 << (bits - 1)
    vals = packing.unpack_words(q, bits, hd, axis=-1)
    return (vals.to(dtype) - zp) * scale.to(dtype)[..., None]


def cache_read(cache, dtype, kv_bits: int = 0, hd: int | None = None):
    """The whole contiguous cache as (k, v) [B, S, KVH, hd] in ``dtype``
    (the reference's ``_cache_read``; float caches come back as stored)."""
    if "k_scale" in cache:
        return (kv_dequantize(cache["k"], cache["k_scale"], dtype, kv_bits,
                              hd),
                kv_dequantize(cache["v"], cache["v_scale"], dtype, kv_bits,
                              hd))
    return cache["k"], cache["v"]


def paged_cache_read(cache, block_tables, dtype, kv_bits: int = 0,
                     hd: int | None = None):
    """Each row's pages gathered into the logical [B, NP * page_size, KVH,
    hd] view and dequantized (the reference's ``_paged_cache_read``).  Table
    entries are clipped to [0, P-1], as the reference's gather clips
    them."""
    bt = block_tables.to(torch.int64).clamp(0, cache["k"].shape[0] - 1)

    def gather(buf):
        g = buf[bt]                          # [B, NP, ps, KVH, ...]
        return g.reshape(g.shape[0], -1, *g.shape[3:])

    if "k_scale" in cache:
        return (kv_dequantize(gather(cache["k"]), gather(cache["k_scale"]),
                              dtype, kv_bits, hd),
                kv_dequantize(gather(cache["v"]), gather(cache["v_scale"]),
                              dtype, kv_bits, hd))
    return gather(cache["k"]), gather(cache["v"])


def ring_positions(cache_index, size: int, window: int):
    """[size] absolute position each slot holds (-1 = empty) after a
    lockstep write at ``cache_index`` (0-d): the reference's
    ``_ring_positions``, :func:`ring_positions_batch` of one row."""
    return ring_positions_batch(cache_index.reshape(1), size, window)[0]


def ring_positions_batch(last, size: int, window: int):
    """[B, size] absolute position each slot of each row holds, given the
    row's last written position ``last`` [B] (-1 = row empty): slots up to
    it without a window, else the latest position p <= last with p % size
    == slot (the reference's ``_ring_positions_batch``)."""
    slots = torch.arange(size, dtype=torch.int64, device=last.device)[None]
    last = last.to(torch.int64)[:, None]
    if not window:
        return torch.where(slots <= last, slots, -1)
    pos = last - ((last % size - slots) % size)
    return torch.where(pos >= 0, pos, -1)


def use_fused_decode(window: int, cache_index, sq: int) -> bool:
    """The reference's ``_use_fused_decode`` gate, read when the step runs
    or is captured: the fused read serves a non-windowed self-attention
    cache read with per-row offsets, or by one lockstep token, unless
    ``REPRO_FUSED_DECODE=0``."""
    if not ulppack_attention.enabled() or window:
        return False
    return cache_index.dim() > 0 or sq == 1


NEG_INF = -1e30
Q_CHUNK = 512     # the reference's q-chunk when its tuning cache misses


def chunked_attention(q, k, v, mask_fn, q_positions, chunk: int = Q_CHUNK):
    """Exact softmax attention, q-chunked to bound the score buffer (the
    reference's ``_chunked_attention``).

    q: [B, Sq, H, hd]; k, v: [B, Sk, KVH, hd], or ``k`` a function
    returning (k, v) and ``v`` None: it is called inside each chunk's body,
    so a stored cache is expanded (gathered, unpacked, dequantized) per
    chunk and never held whole at full precision across the call.
    ``mask_fn(qpos [B, C])`` -> [B, C, Sk] boolean validity.  The scores
    and the value product take the operands in q's dtype (the reference's
    ``opd``) and accumulate in f32: bf16 operands are widened first, which
    is exact.  Where ``Sq > chunk`` each full chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its [C, Sk]
    scores instead of storing them.  The forward runs in an ``attention``
    profiler range.  Returns [B, Sq, H, hd] in q's dtype."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    opd = q.dtype
    kv_fn = k if v is None else (lambda: (k, v))

    def one_chunk(qc, qpos):
        c = qc.shape[1]
        kc, vc = kv_fn()
        kvh = kc.shape[2]
        groups = h // kvh
        k32 = kc.to(opd).to(torch.float32)
        v32 = vc.to(opd).to(torch.float32)
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


def _causal(positions, sk, window: int = 0):
    """The mask over a window's own keys: key position <= query position,
    and within ``window`` positions of it when one is set."""
    return _position_mask(positions[:, :sk], window)


def _all_keys(sk: int):
    """The mask that admits every one of ``sk`` keys (the reference's
    non-causal and cross-attention masks, without a window)."""
    def mask_fn(qpos):
        return torch.ones((qpos.shape[0], qpos.shape[1], sk),
                          dtype=torch.bool, device=qpos.device)
    return mask_fn


def _position_mask(kv_pos, window: int):
    """The mask over keys at positions ``kv_pos`` ([Sk] shared, [B, Sk] per
    row; -1 an empty slot): ``kp <= qpos & kp >= 0``, and ``qpos - kp <
    window`` when a window is set."""
    def mask_fn(qpos):
        kp = kv_pos[:, None, :] if kv_pos.dim() == 2 \
            else kv_pos[None, None, :]
        m = (kp <= qpos[:, :, None]) & (kp >= 0)
        if window:
            m = m & ((qpos[:, :, None] - kp) < window)
        return m
    return mask_fn


def legacy_read(cfg, q, cache, kv_pos, positions, dtype, *,
                block_tables=None):
    """The legacy read of a written cache: the stored (paged: gathered)
    cache dequantized per q-chunk into :func:`chunked_attention` under the
    ring-position mask -- ``kp <= qpos & kp >= 0``, and ``qpos - kp <
    window`` for a windowed contiguous cache.  ``dtype`` is the dequantized
    K/V's (the projections')."""
    b, sq, h, hd = q.shape
    kv_bits = cfg.quant.kv_bits
    if block_tables is None:
        skv = cache["k"].shape[1]
        window = cfg.sliding_window

        def kv_fn():
            return cache_read(cache, dtype, kv_bits, hd)
    else:
        skv = block_tables.shape[1] * cache["k"].shape[1]
        window = 0

        def kv_fn():
            return paged_cache_read(cache, block_tables, dtype, kv_bits, hd)
    chunk = autotune.attention_chunk_for(b, sq, skv, h, cache["k"].shape[2],
                                         hd, int(kv_bits))
    with torch.profiler.record_function("legacy_attention"):
        return chunked_attention(q, kv_fn, None,
                                 _position_mask(kv_pos, window), positions,
                                 chunk)


def precompute_cross_kv(p, cfg, enc_out, *, quant_mode="none",
                        backend="auto"):
    """The encoder states' K and V [B, S_enc, KVH, hd] in the compute
    dtype, projected once by a cross layer's (packed) k and v and reused by
    every decoder call (the reference's ``precompute_cross_kv``)."""
    b = enc_out.shape[0]
    hd = cfg.resolved_head_dim
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode,
              compute_dtype=common.dtype_of(cfg.compute_dtype),
              backend=backend)
    k = dense_apply(p["k"], enc_out, **qm).reshape(b, -1, cfg.num_kv_heads,
                                                   hd)
    v = dense_apply(p["v"], enc_out, **qm).reshape(b, -1, cfg.num_kv_heads,
                                                   hd)
    return k, v


def _read_all(q, k, v, positions, chunk, train, backend):
    """Cache-free attention of q over every key of k / v: through K3 with
    ``valid_len`` the key count and every query at the last key's
    position, or in a training forward (or under the kill-switch) through
    :func:`chunked_attention` under the all-true mask."""
    b, sq, _, hd = q.shape
    sk = k.shape[1]
    if train or not ulppack_attention.enabled():
        return chunked_attention(q, k, v, _all_keys(sk), positions, chunk)
    return ulppack_attention.fused_decode_attention(
        q, {"k": k, "v": v},
        torch.full((b,), sk, dtype=torch.int32, device=q.device),
        torch.full((b, sq), sk - 1, dtype=torch.int32, device=q.device),
        kv_bits=0, hd=hd, backend=backend)


def attention_apply(p, cfg, x, *, positions, quant_mode="none", cache=None,
                    cache_index=None, cache_valid=None, dest=None,
                    block_tables=None, backend="auto", causal=True,
                    positions3=None, cross_kv=None):
    """Attention forward; returns (out, cache).

      * cache=None: causal (and windowed) self-attention over the window's
        own K/V -- through K3 when serving a non-windowed config, through
        :func:`chunked_attention` in a training forward (``quant_mode=
        'qat'``, or autograd recording), for a windowed config or under
        ``REPRO_FUSED_DECODE=0``.
      * cache without cache_index: the prefill of a fresh cache -- the
        window's K/V fill rows 0 .. s-1 (a ring keeps the last ``size``
        tokens at slot ``pos % size``, :func:`prefill_dest_rows`) and the
        query attends over the raw window (:func:`chunked_attention`), as
        the reference's fake-quant prefill step does.
      * cache + cache_index ([B] per-row write offsets, or a scalar: the
        lockstep path, see :func:`window`): the window's K/V is written
        into the cache in place -- tokens past ``cache_valid[b]`` dropped,
        ring slots ``pos % size`` for a windowed config -- and the query
        reads the stored cache, fused (``valid_len = cache_index +
        cache_valid``) or legacy (:func:`legacy_read`), as
        :func:`use_fused_decode` decides.  ``dest`` may carry the window's
        precomputed destination rows; the offsets, counts and table must
        then be device tensors (:func:`window`).
      * paged: ``block_tables`` [B, n_pages] int32 maps each row's logical
        page j to a physical page of a pool (:func:`init_paged_kv_cache`).
        Writes land through the table (:func:`paged_dest_rows`); the fused
        read walks the pool through the table (K4), so the gathered view
        never materializes, and the legacy read gathers it per q-chunk.
        Windowed configs are never paged.
      * ``causal=False`` (the encoder): cache-free self-attention in which
        every query sees every key of the window (refused for a windowed
        config, which no encoder has).
      * ``cross_kv`` (k, v) [B, S_enc, KVH, hd] (:func:`precompute_cross_kv`):
        cross-attention -- q is not rotated, every key is seen, no cache is
        read or written.
    """
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    win = cfg.sliding_window
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    q = dense_apply(p["q"], x, **qm).reshape(b, sq, cfg.num_heads, hd)
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, sq)
    train = quant_mode == "qat" or (torch.is_grad_enabled()
                                     and q.requires_grad)
    if cross_kv is not None:
        k, v = cross_kv
        chunk = autotune.attention_chunk_for(
            b, sq, k.shape[1], cfg.num_heads, cfg.num_kv_heads, hd,
            int(cfg.quant.kv_bits))
        out = _read_all(q, k, v, positions, chunk, train, backend)
        out = dense_apply(p["o"], out.reshape(b, sq, cfg.num_heads * hd),
                          **qm)
        return out, cache
    k = dense_apply(p["k"], x, **qm).reshape(b, sq, cfg.num_kv_heads, hd)
    v = dense_apply(p["v"], x, **qm).reshape(b, sq, cfg.num_kv_heads, hd)
    if cfg.mrope and positions3 is not None:
        positions3 = torch.as_tensor(positions3, dtype=torch.int32,
                                     device=x.device)
        q = common.apply_mrope(q, positions3, cfg.mrope_sections,
                               cfg.rope_theta)
        k = common.apply_mrope(k, positions3, cfg.mrope_sections,
                               cfg.rope_theta)
    else:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)

    if cache is None or cache_index is None:
        # the q-chunk of chunked_attention: the tuned one for this
        # signature, Q_CHUNK on a miss (the reference's
        # _attention_epilogue does the same lookup)
        chunk = autotune.attention_chunk_for(
            b, sq, sq, cfg.num_heads, cfg.num_kv_heads, hd,
            int(cfg.quant.kv_bits))
    if cache is None and not causal:
        if win:
            raise NotImplementedError(
                "a non-causal sliding-window forward: no config has a "
                "windowed encoder")
        out = _read_all(q, k, v, positions, chunk, train, backend)
    elif cache is not None and cache_index is None:
        # the fake-quant prefill: the window fills a fresh cache, and the
        # query attends over the raw window
        if sharding.num_shards(cache):
            raise NotImplementedError(
                "the fresh-cache prefill of a kv-head-split cache; serving "
                "steps pass cache_index")
        rows = prefill_dest_rows(b, sq, cache["k"].shape[1], bool(win),
                                 x.device)
        cache_write(cache, k.detach(), v.detach(), rows, cfg.quant.kv_bits,
                    backend=backend)
        out = chunked_attention(q, k, v, _causal(positions, sq, win),
                                positions, chunk)
    elif cache is None and (train or win or not ulppack_attention.enabled()):
        out = chunked_attention(q, k, v, _causal(positions, sq, win),
                                positions, chunk)
    elif cache is None:
        full = torch.full((b,), sq, dtype=torch.int32, device=x.device)
        out = ulppack_attention.fused_decode_attention(
            q, {"k": k, "v": v}, full, positions, kv_bits=0, hd=hd,
            backend=backend)
    else:
        if block_tables is not None and win:
            raise NotImplementedError(
                "paged KV cache + sliding-window ring do not compose; "
                "serve sliding-window archs unpaged")
        if dest is None:
            cache_index, cache_valid, dest, block_tables = window(
                cache_index, cache_valid, block_tables, b, sq,
                cache["k"].shape, x.device, sliding_window=win)
        if win and sq > 1 and cache_index.dim() > 0:
            raise NotImplementedError(
                "chunked ragged prefill over a sliding-window ring would "
                "overwrite slots still visible to earlier queries of the "
                "same window; feed ring-cache archs token-by-token "
                "(ServingEngine clamps prefill_chunk to 1 for them)")
        window_args = (cache_index, cache_valid, dest, block_tables,
                       positions)
        n_shards = sharding.num_shards(cache)
        if not n_shards:
            out = _cached_attention(cfg, q, k, v, cache, *window_args,
                                    backend)
        else:
            # the cache's kv heads split over the shards: each shard
            # writes and reads its own KVH / tp kv heads for the H / tp
            # query heads that use them; the head outputs join before o
            hq, hkv = cfg.num_heads // n_shards, \
                cfg.num_kv_heads // n_shards
            outs = []
            for i in range(n_shards):
                dev = sharding.shard_device(cache, i)
                heads = [t[:, :, i * n:(i + 1) * n].contiguous().to(dev)
                         for t, n in ((q, hq), (k, hkv), (v, hkv))]
                args = [None if t is None else t.to(dev)
                        for t in window_args]
                outs.append(_cached_attention(
                    cfg, *heads, sharding.local(cache, i), *args,
                    backend))
            out = sharding.join(outs, x.device, dim=2)
    out = dense_apply(p["o"], out.reshape(b, sq, cfg.num_heads * hd), **qm)
    return out, cache


def _cached_attention(cfg, q, k, v, cache, cache_index, cache_valid, dest,
                      block_tables, positions, backend):
    """The window's K/V written into ``cache`` in place through ``dest``,
    then the query's read of the stored cache: fused (K3, K4 with a block
    table) or the legacy read, as :func:`use_fused_decode` decides.
    Returns [B, sq, H, hd]."""
    win, hd, kv_bits = cfg.sliding_window, cfg.resolved_head_dim, \
        cfg.quant.kv_bits
    cache_write(cache, k, v, dest, kv_bits, backend=backend)
    if use_fused_decode(win, cache_index, q.shape[1]):
        return ulppack_attention.fused_decode_attention(
            q, cache, cache_index + cache_valid, positions,
            kv_bits=kv_bits, hd=hd, block_tables=block_tables,
            backend=backend)
    if cache_index.dim() == 0:
        kv_pos = ring_positions(cache_index, cache["k"].shape[1], win)
    else:
        size = (cache["k"].shape[1] if block_tables is None
                else block_tables.shape[1] * cache["k"].shape[1])
        kv_pos = ring_positions_batch(cache_index + cache_valid - 1, size,
                                      win if block_tables is None else 0)
    return legacy_read(cfg, q, cache, kv_pos, positions, k.dtype,
                       block_tables=block_tables)
