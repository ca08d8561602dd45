"""K3 and K4: flash-decoding attention over the stored (possibly sub-byte)
KV cache, contiguous (K3) or paged (K4).

Replaces ``repro/kernels/ulppack_attention.py:_attention_decode_pallas``
(Pallas kernel ``_decode_kernel``): its contiguous-cache branch (K3,
pallas_call at :395) and its paged branch (K4, pallas_call at :367, which
walks a pool [P, page_size, KVH, ...] through the scalar-prefetched block
table ``bt[i, j]`` clipped to [0, P-1]).  The hand-written kernels are
``csrc/attention_decode.cu`` (one kernel, templated on the cache layout;
two launchers; one launch per call, with the q scaling, Σq and the output
cast inside); unlike the Pallas kernel (one query token only) they take
query windows of any width C >= 1, so decode steps and chunked-prefill
windows both run through them.  Their geometry (query rows per block,
splits, rows per split and per staged tile, shared memory) comes from
``plan.plan_attention_decode``.  The source note says what bounds them
and how they are laid out.

The computation, for q [B, C, H, hd] and a contiguous cache [B, S, KVH, ...]:
  * float caches (kv_bits 0/16) are read directly; int8 caches are
    symmetric with per-(pos, kv-head) bf16 scales; 4/2-bit caches are
    int32 words unpacked with the midpoint zero-point folded
    into the contraction: ``s = scale_k * (q.u - zp * sum(q))`` and values
    ``(p * scale_v) . u - zp * sum(p * scale_v)``;
  * q is pre-scaled by hd^-0.5 in f32 and Σq taken from the scaled q;
  * visible positions are ``pos < valid_len & pos <= qpos``; masked scores
    are NEG_INF = -1e30 and masked probabilities exactly 0;
  * a row with nothing visible returns exact zeros (the ``l == 0`` guard);
  * the output has q's dtype.

A paged cache is read through ``block_tables`` [B, NP] int32: logical
position p of row b lives at physical page ``bt[b, p // page_size]``
(clipped to [0, P-1]), row ``p % page_size``; the logical length is
``NP * page_size``.

:func:`attention_decode_torch` is the plain PyTorch version of both (the
math of the reference's ``_attention_decode_xla``, :158-223, which gathers
each group's pages through the table); ``kernel_launches`` /
``plain_calls`` count each kernel's launches and each plain version's
calls, keyed by kernel name, and ``tile_launches`` the launches that took
the kernel's tile path (more than 4 query rows a block, on the bf16
tensor cores: prefill chunks, verify windows, GQA groups past 4, the
encoder); the rest took its warp path.

``REPRO_FUSED_DECODE=0`` in the environment turns the fused read off
(:func:`enabled`, :func:`disabled`): models/attention.py then takes the
legacy whole-view read.  It is the reference's variable, so one setting
flips both packages.
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

NEG_INF = -1e30

NAMES = ("attention_decode", "attention_decode_paged")

#: Launches of each CUDA kernel / calls of each plain version in this
#: process, keyed by kernel name (K3 contiguous, K4 paged), and the
#: launches of each kernel that took its tile path
#: (``plan.attention_warp_path`` false); the others took the warp path.
kernel_launches = dict.fromkeys(NAMES, 0)
plain_calls = dict.fromkeys(NAMES, 0)
tile_launches = dict.fromkeys(NAMES, 0)

_launch: dict = {}


def reset_counts():
    for k in NAMES:
        kernel_launches[k] = plain_calls[k] = tile_launches[k] = 0


#: Environment kill-switch: "0" disables the fused decode read everywhere
#: (models/attention.py falls back to the legacy whole-view read).  Read
#: when a step runs eagerly or is captured: a captured CUDA graph keeps
#: the read it was captured with.
ENV_FLAG = "REPRO_FUSED_DECODE"


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "1") != "0"


@contextlib.contextmanager
def disabled():
    """Run with the fused decode read off (the legacy read's references
    come from the same process)."""
    old = os.environ.get(ENV_FLAG)
    os.environ[ENV_FLAG] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(ENV_FLAG, None)
        else:
            os.environ[ENV_FLAG] = old


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _unpack_group(words: torch.Tensor, bits: int, hd: int) -> torch.Tensor:
    """int32 words [..., hdw] -> f32 lattice values [..., hd] (ascending
    field order, tail dropped)."""
    per = 32 // bits
    mask = (1 << bits) - 1
    shifts = torch.arange(per, dtype=torch.int32, device=words.device) * bits
    vals = (words[..., None] >> shifts) & mask          # [..., hdw, per]
    vals = vals.reshape(*words.shape[:-1], words.shape[-1] * per)
    return vals[..., :hd].to(torch.float32)


def _prep_q(q: torch.Tensor, kvh: int):
    """[B, C, H, hd] -> pre-scaled f32 [B, C, KVH, G, hd] + row sums."""
    b, c, h, hd = q.shape
    qg = (q.to(torch.float32) * hd ** -0.5).reshape(b, c, kvh, h // kvh, hd)
    return qg, qg.sum(dim=-1)


def _scale_broadcast(gs):
    if gs is None:
        return None
    return gs.to(torch.float32).permute(0, 2, 1)[:, None, :, None, :]


def _group_scores(qg, qsum, gk, gsk, kv_bits, hd, zp):
    u = (_unpack_group(gk, kv_bits, hd) if kv_bits in (4, 2)
         else gk.to(torch.float32))
    s = torch.einsum("bckgd,bskd->bckgs", qg, u)
    if gsk is not None:
        ss = _scale_broadcast(gsk)
        s = ss * (s - zp * qsum[..., None] if zp else s)
    return s


def _combine(carry, s, ok, u_v, ssv, zp):
    """One online-softmax step over a group's masked scores."""
    m, l, acc = carry
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    mn = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - mn)
    p = torch.where(ok, torch.exp(s - mn[..., None]), torch.zeros_like(s))
    l2 = l * corr + p.sum(dim=-1)
    pv = p if ssv is None else p * ssv
    av = torch.einsum("bckgs,bskd->bckgd", pv, u_v)
    if zp:
        av = av - (zp * pv.sum(dim=-1))[..., None]
    return mn, l2, acc * corr[..., None] + av


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def attention_decode_torch(q, cache, valid_len, qpos, *, kv_bits: int,
                           hd: int, block_k: int | None = None,
                           block_tables=None):
    """Group loop with an online-softmax carry; on the CPU, groups that
    start at or past ``max(valid_len)`` are skipped (O(live), like the
    reference).  With ``block_tables`` the cache is a page pool and each
    group gathers its rows through the table (clipped to [0, P-1]); a
    group is then ``block_k // page_size`` whole pages."""
    b, c, h, _ = q.shape
    kvh = cache["k"].shape[2]
    quantized = "k_scale" in cache
    if block_tables is None:
        plain_calls["attention_decode"] += 1
        skv = cache["k"].shape[1]
        bk = max(1, block_k or skv)

        def read(t0):
            return {n: t[:, t0:t0 + bk] for n, t in cache.items()}
    else:
        plain_calls["attention_decode_paged"] += 1
        ps = cache["k"].shape[1]
        bt = block_tables.to(torch.int64).clamp(0, cache["k"].shape[0] - 1)
        skv = bt.shape[1] * ps
        pp = max(1, (block_k or skv) // ps)
        bk = pp * ps

        def read(t0):
            pages = bt[:, t0 // ps:t0 // ps + pp]
            return {n: t[pages].reshape(b, -1, *t.shape[2:])
                    for n, t in cache.items()}
    zp = (1 << (kv_bits - 1)) if kv_bits in (4, 2) else 0
    qg, qsum = _prep_q(q, kvh)
    groups = h // kvh
    dev = q.device
    carry = (torch.full((b, c, kvh, groups), NEG_INF, device=dev),
             torch.zeros((b, c, kvh, groups), device=dev),
             torch.zeros((b, c, kvh, groups, hd), device=dev))
    # skip groups past every row's live length, as the reference does; on
    # the card that needs a host sync, which costs more than reading the
    # masked tail, so there every group runs (same result, masked)
    live_max = (skv if valid_len.is_cuda or not valid_len.numel()
                else int(valid_len.max()))
    for t0 in range(0, min(skv, live_max), bk):
        g = read(t0)
        gk, gv = g["k"], g["v"]
        gsk = g["k_scale"] if quantized else None
        gsv = g["v_scale"] if quantized else None
        s = _group_scores(qg, qsum, gk, gsk, kv_bits, hd, zp)
        pos = t0 + torch.arange(gk.shape[1], dtype=torch.int32, device=dev)
        ok = ((pos[None, None, :] < valid_len[:, None, None])
              & (pos[None, None, :] <= qpos[:, :, None]))[:, :, None, None, :]
        u_v = (_unpack_group(gv, kv_bits, hd) if kv_bits in (4, 2)
               else gv.to(torch.float32))
        carry = _combine(carry, s, ok, u_v, _scale_broadcast(gsv), zp)
    m, l, acc = carry
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.reshape(b, c, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _cache_kind(cache, kv_bits: int) -> int:
    """The kernel's cache-kind code (csrc/attention_decode.cu)."""
    k = cache["k"]
    if "k_scale" not in cache:
        kinds = {torch.float32: 0, torch.bfloat16: 1}
        if k.dtype not in kinds:
            raise TypeError(f"float cache must be f32 or bf16, got {k.dtype}")
        return kinds[k.dtype]
    if kv_bits == 8 and k.dtype == torch.int8:
        return 2
    if kv_bits in (4, 2) and k.dtype == torch.int32:
        return 3
    raise TypeError(f"cache dtype {k.dtype} does not match kv_bits {kv_bits}")


#: q's dtype -> the kernel's q / output type code (csrc/attention_decode.cu).
_QTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _launch_args(q, cache, valid_len, qpos, kv_bits, tensors):
    """Checks shared by both launchers; returns the scale planes (or None),
    the cache kind, q's type code and the output (q's dtype).  q is read
    as it is: the kernel scales it, sums it and casts its output itself."""
    b, c, h, hd = q.shape
    k, v = cache["k"], cache["v"]
    kind = _cache_kind(cache, kv_bits)
    tensors = [q, k, v, valid_len, qpos, *tensors]
    if kind >= 2:
        tensors += [cache["k_scale"], cache["v_scale"]]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("the attention kernels need every operand on the "
                         "query's CUDA device")
    if q.dtype not in _QTYPES:
        raise TypeError(f"q must be f32, bf16 or f16, got {q.dtype}")
    if any(not t.is_contiguous() for t in (k, v)):
        raise ValueError("the KV cache must be contiguous")
    if v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} / {tuple(v.shape)}")
    if valid_len.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError("valid_len and qpos must be int32")
    if valid_len.shape != (b,) or qpos.shape != (b, c):
        raise ValueError(f"valid_len {tuple(valid_len.shape)} / qpos "
                         f"{tuple(qpos.shape)} do not match q "
                         f"{tuple(q.shape)}")
    scales = ((cache["k_scale"].contiguous(), cache["v_scale"].contiguous())
              if kind >= 2 else (None, None))
    out = torch.empty((b, c, h, hd), dtype=q.dtype, device=q.device)
    return scales, kind, _QTYPES[q.dtype], out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _geometry(plan):
    """The kernel's launch geometry from a plan (the C launcher refuses a
    geometry that breaks its constraints or its shared-memory layout)."""
    return (plan.block_m, plan.split_rows, plan.splits, plan.tile_rows,
            plan.threads, plan.smem_bytes)


def _count(name, plan, hd):
    """One launch of ``name``, and of its tile path where the plan's rows
    take it."""
    kernel_launches[name] += 1
    if not plan_lib.attention_warp_path(plan.block_m, hd):
        tile_launches[name] += 1


def attention_decode_cuda(q, cache, valid_len, qpos, *, kv_bits: int,
                          hd: int, plan=None):
    """Launch K3 over a contiguous cache [B, S, KVH, ...] on the card, with
    the geometry of ``plan`` (``plan_attention_decode`` for these shapes
    when None)."""
    b, c, h, _ = q.shape
    k, v = cache["k"], cache["v"]
    kvh, skv = k.shape[2], k.shape[1]
    if k.shape[:3] != (b, skv, kvh):
        raise ValueError(f"cache shape {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    (ks, vs), kind, qtype, out = _launch_args(q, cache, valid_len, qpos,
                                              kv_bits, [])
    q = q.contiguous()
    if plan is None:
        plan = plan_lib.plan_attention_decode(
            b, c, skv, h, kvh, hd, kv_bits, cache_dtype=k.dtype,
            backend="cuda", device=q.device)
    if b * c * h:
        fn = _launch.get("attention_decode")
        if fn is None:
            fn = _launch["attention_decode"] = build.bind(
                "attention_decode", "attention_decode_launch", 8, 16)
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
           valid_len.contiguous().data_ptr(), qpos.contiguous().data_ptr(),
           out.data_ptr(), b, c, h, kvh, skv, hd, k.shape[-1], kind,
           kv_bits, qtype, *_geometry(plan), q.device.index or 0,
           torch.cuda.current_stream(q.device).cuda_stream)
        _count("attention_decode", plan, hd)
    return out


def attention_decode_paged_cuda(q, cache, valid_len, qpos, block_tables, *,
                                kv_bits: int, hd: int, plan=None):
    """Launch K4 over a page pool [P, page_size, KVH, ...] through
    ``block_tables`` [B, NP] int32 on the card: K3's kernel, staging each
    split's rows through its table entries."""
    b, c, h, _ = q.shape
    k, v = cache["k"], cache["v"]
    num_pages, ps, kvh = k.shape[:3]
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be int32 [B={b}, NP], got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    (ks, vs), kind, qtype, out = _launch_args(q, cache, valid_len, qpos,
                                              kv_bits, [block_tables])
    q = q.contiguous()
    bt = block_tables.contiguous()
    n_pages = bt.shape[1]
    if plan is None:
        plan = plan_lib.plan_attention_decode(
            b, c, n_pages * ps, h, kvh, hd, kv_bits, page_size=ps,
            cache_dtype=k.dtype, backend="cuda", device=q.device)
    if b * c * h:
        fn = _launch.get("attention_decode_paged")
        if fn is None:
            fn = _launch["attention_decode_paged"] = build.bind(
                "attention_decode_paged", "attention_decode_paged_launch",
                9, 18)
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
           valid_len.contiguous().data_ptr(), qpos.contiguous().data_ptr(),
           bt.data_ptr(), out.data_ptr(), b, c, h, kvh, n_pages, ps,
           num_pages, hd, k.shape[-1], kind, kv_bits, qtype,
           *_geometry(plan), q.device.index or 0,
           torch.cuda.current_stream(q.device).cuda_stream)
        _count("attention_decode_paged", plan, hd)
    return out


@plan_lib.register_backend("attention_decode", "torch")
def _attention_decode_torch(plan, q, cache, valid_len, qpos, *, kv_bits, hd,
                            block_tables=None):
    return attention_decode_torch(q, cache, valid_len, qpos, kv_bits=kv_bits,
                                  hd=hd, block_k=plan.block_k,
                                  block_tables=block_tables)


@plan_lib.register_backend("attention_decode", "cuda")
def _attention_decode_cuda(plan, q, cache, valid_len, qpos, *, kv_bits, hd,
                           block_tables=None):
    if block_tables is not None:
        return attention_decode_paged_cuda(q, cache, valid_len, qpos,
                                           block_tables, kv_bits=kv_bits,
                                           hd=hd, plan=plan)
    return attention_decode_cuda(q, cache, valid_len, qpos, kv_bits=kv_bits,
                                 hd=hd, plan=plan)


# ---------------------------------------------------------------------------
# Entry point (models/attention.py)
# ---------------------------------------------------------------------------

def fused_decode_attention(q, cache, valid_len, qpos, *, kv_bits: int,
                           hd: int, plan=None, block_tables=None,
                           backend: str = "auto"):
    """Flash-decoding attention over the stored cache.

    q [B, C, H, hd]; ``cache`` the stored layout (models/attention.
    init_kv_cache, or init_paged_kv_cache with ``block_tables`` [B, NP]
    int32); ``valid_len`` [B] live token rows per sequence (logical-view
    prefix); ``qpos`` [B, C] absolute query positions.  Returns
    [B, C, H, hd] in q.dtype."""
    b, c, h, _ = q.shape
    dev = q.device
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                       device=dev)
    if plan is None:
        page_size = cache["k"].shape[1] if block_tables is not None else None
        skv = (block_tables.shape[1] * cache["k"].shape[1]
               if block_tables is not None else cache["k"].shape[1])
        plan = plan_lib.plan_attention_decode(
            b, c, skv, h, cache["k"].shape[2], hd, kv_bits,
            page_size=page_size, cache_dtype=cache["k"].dtype,
            backend=backend, device=dev)
    return plan_lib.dispatch(
        plan, q, cache, torch.as_tensor(valid_len, dtype=torch.int32,
                                        device=dev),
        torch.as_tensor(qpos, dtype=torch.int32, device=dev),
        kv_bits=kv_bits, hd=hd, block_tables=block_tables)
