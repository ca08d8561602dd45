"""K3: flash-decoding attention over the stored (possibly sub-byte) KV cache.

Replaces the contiguous-cache branch of
``repro/kernels/ulppack_attention.py:_attention_decode_pallas`` (Pallas
kernel ``_decode_kernel``, pallas_call at :395).  The hand-written kernel is
``csrc/attention_decode.cu``; unlike the Pallas kernel (one query token
only) it takes query windows of any width C >= 1, so decode steps and
chunked-prefill windows both run through it.  Its source note says what
bounds it and how it is laid out.

The computation, for q [B, C, H, hd] and a contiguous cache [B, S, KVH, ...]:
  * float caches (kv_bits 0/16) are read directly; int8 caches are
    symmetric with per-(pos, kv-head) bf16 scales; 4/2-bit caches are
    int32 words unpacked in registers with the midpoint zero-point folded
    into the contraction: ``s = scale_k * (q.u - zp * sum(q))`` and values
    ``(p * scale_v) . u - zp * sum(p * scale_v)``;
  * q is pre-scaled by hd^-0.5 in f32 and Σq taken from the scaled q;
  * visible positions are ``pos < valid_len & pos <= qpos``; masked scores
    are NEG_INF = -1e30 and masked probabilities exactly 0;
  * a row with nothing visible returns exact zeros (the ``l == 0`` guard);
  * the output has q's dtype.

:func:`attention_decode_torch` is the plain PyTorch version (the math of
the reference's ``_attention_decode_xla``, :158-223); ``kernel_launches`` /
``plain_calls`` count each.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

NEG_INF = -1e30

#: Launches of the CUDA kernel / calls of the plain version in this process.
kernel_launches = 0
plain_calls = 0

_launch = None


def reset_counts():
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


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
                           hd: int, block_k: int | None = None):
    """Group loop with an online-softmax carry; on the CPU, groups that
    start at or past ``max(valid_len)`` are skipped (O(live), like the
    reference)."""
    global plain_calls
    plain_calls += 1
    b, c, h, _ = q.shape
    kvh = cache["k"].shape[2]
    skv = cache["k"].shape[1]
    zp = (1 << (kv_bits - 1)) if kv_bits in (4, 2) else 0
    quantized = "k_scale" in cache
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
    bk = max(1, block_k or skv)
    for t0 in range(0, min(skv, live_max), bk):
        sl = slice(t0, t0 + bk)
        gk, gv = cache["k"][:, sl], cache["v"][:, sl]
        gsk = cache["k_scale"][:, sl] if quantized else None
        gsv = cache["v_scale"][:, sl] if quantized else None
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


def attention_decode_cuda(q, cache, valid_len, qpos, *, kv_bits: int,
                          hd: int):
    """Launch the CUDA kernel over a contiguous cache on the card."""
    global kernel_launches, _launch
    b, c, h, _ = q.shape
    k, v = cache["k"], cache["v"]
    kvh, skv = k.shape[2], k.shape[1]
    kind = _cache_kind(cache, kv_bits)
    tensors = [q, k, v, valid_len, qpos]
    if kind >= 2:
        tensors += [cache["k_scale"], cache["v_scale"]]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("attention_decode_cuda needs every operand on the "
                         "query's CUDA device")
    if any(not t.is_contiguous() for t in (k, v)):
        raise ValueError("the KV cache must be contiguous")
    if k.shape[:3] != (b, skv, kvh) or v.shape != k.shape:
        raise ValueError(f"cache shape {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if valid_len.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError("valid_len and qpos must be int32")
    qg, qsum = _prep_q(q, kvh)
    qg, qsum = qg.contiguous(), qsum.contiguous()
    vl = valid_len.contiguous()
    qp = qpos.contiguous()
    out = torch.empty((b, c, h, hd), dtype=torch.float32, device=q.device)
    ks = cache["k_scale"].contiguous() if kind >= 2 else None
    vs = cache["v_scale"].contiguous() if kind >= 2 else None
    if b * c * h:
        if _launch is None:
            _launch = build.bind("attention_decode",
                                 "attention_decode_launch", 9, 9)
        _launch(qg.data_ptr(), qsum.data_ptr(), k.data_ptr(), v.data_ptr(),
                ks.data_ptr() if ks is not None else None,
                vs.data_ptr() if vs is not None else None,
                vl.data_ptr(), qp.data_ptr(), out.data_ptr(),
                b, c, h, kvh, skv, hd, k.shape[-1], kind, kv_bits,
                q.device.index or 0,
                torch.cuda.current_stream(q.device).cuda_stream)
        kernel_launches += 1
    return out.to(q.dtype)


@plan_lib.register_backend("attention_decode", "torch")
def _attention_decode_torch(plan, q, cache, valid_len, qpos, *, kv_bits, hd):
    return attention_decode_torch(q, cache, valid_len, qpos, kv_bits=kv_bits,
                                  hd=hd, block_k=plan.block_k)


@plan_lib.register_backend("attention_decode", "cuda")
def _attention_decode_cuda(plan, q, cache, valid_len, qpos, *, kv_bits, hd):
    return attention_decode_cuda(q, cache, valid_len, qpos, kv_bits=kv_bits,
                                 hd=hd)


# ---------------------------------------------------------------------------
# Entry point (models/attention.py)
# ---------------------------------------------------------------------------

def fused_decode_attention(q, cache, valid_len, qpos, *, kv_bits: int,
                           hd: int, plan=None, backend: str = "auto"):
    """Flash-decoding attention over the stored contiguous cache.

    q [B, C, H, hd]; ``cache`` the stored layout (models/attention.
    init_kv_cache); ``valid_len`` [B] live token rows per sequence;
    ``qpos`` [B, C] absolute query positions.  Returns [B, C, H, hd] in
    q.dtype."""
    b, c, h, _ = q.shape
    if plan is None:
        plan = plan_lib.plan_attention_decode(
            b, c, cache["k"].shape[1], h, cache["k"].shape[2], hd, kv_bits,
            backend=backend, device=q.device)
    return plan_lib.dispatch(
        plan, q, cache, torch.as_tensor(valid_len, dtype=torch.int32,
                                        device=q.device),
        torch.as_tensor(qpos, dtype=torch.int32, device=q.device),
        kv_bits=kv_bits, hd=hd)
