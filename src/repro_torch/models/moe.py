"""Mixture-of-Experts: top-k router and two execution paths (counterpart of
``repro/models/moe.py``).

* 'einsum' -- capacity-bounded one-hot dispatch and combine with group
  blocking (MaxText-style).  Every shape is fixed by the token count, so
  the serving steps capture it in their CUDA graphs.
* 'ragged' -- sort by expert and one product a group, dropless.  Its group
  sizes depend on the data (a host sync), so it stays off the graphed
  path.

Expert FFNs are SwiGLU.  As in the reference, the 3-D expert kernels are
not packed: their products are library GEMMs over LSQ lattices in the
compute dtype, as the reference computes them in XLA without a Pallas
kernel (its ``_expert_kernel``: "packed expert einsums are future work").
A float tree's experts are fake-quantized on every forward in 'qat' and
'packed' modes; the serving prep (``serve/prepare.py``) derives the same
lattices once and drops ``w_step``, so a prepared tree's 'packed'
forward multiplies them as they are, bit-equal.  Outside autograd both
paths fake-quantize and multiply one expert at a time: the step is a
scalar and the lattice elementwise, so every expert's values are
bit-identical to the whole-tensor pass, and the f32 temporaries are one
expert's instead of all of them (at jamba's width, 0.8 GB instead of
12.9 GB).  Under autograd the whole tensor goes through one
``lsq_fake_quant``, whose step gradient is scaled by the whole tensor's
size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.models import common, mlp


def moe_init(generator, cfg, *, dtype=torch.float32, device="cpu"):
    """Router (f32, unquantized) and the up / gate / down expert kernels
    [E, d_in, d_out] in ``dtype``, with LSQ steps when the config
    quantizes; the weight steps come from the kernels as stored."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def ek(din, dout, scale):
        # drawn one expert at a time, so the f32 draw is one expert's
        w = torch.empty((e, din, dout), dtype=dtype, device=device)
        for i in range(e):
            w[i] = torch.randn((din, dout), generator=generator,
                               dtype=torch.float32, device=device) * scale
        return w

    p = {"router": common.dense_init(generator, d, e, dtype=torch.float32,
                                     device=device),
         "up": {"kernel": ek(d, f, 1 / math.sqrt(d))},
         "gate": {"kernel": ek(d, f, 1 / math.sqrt(d))},
         "down": {"kernel": ek(f, d, 1 / math.sqrt(f))}}
    if cfg.quant.enabled:
        for name in ("up", "gate", "down"):
            # the step is linear in the mean of |w|, so the experts' steps
            # average to the whole tensor's
            w = p[name]["kernel"]
            p[name]["w_step"] = torch.stack([
                quant.init_step_from_data(w[i], cfg.quant.w_bits, True)
                for i in range(e)]).mean()
            p[name]["a_step"] = torch.tensor(
                1.0 / math.sqrt(cfg.quant.qmax_a), dtype=torch.float32,
                device=device)
    return p


def expert_lattice(kernel, step, cfg):
    """``kernel``'s LSQ lattice at ``step`` (fake-quantized in f32) in the
    compute dtype: the experts' weights in 'qat' and 'packed' modes, and
    what the serving prep stores in their place."""
    return quant.lsq_fake_quant(kernel.to(torch.float32), step,
                                cfg.quant.w_bits, True).to(
        common.dtype_of(cfg.compute_dtype))


def _expert_kernel(p, name, cfg, quant_mode, expert=None):
    """The ``name`` kernel of every expert [E, d_in, d_out] (of one, [d_in,
    d_out], given ``expert``) in the compute dtype, its lattice
    (``expert_lattice``) in 'qat' and 'packed' modes unless the node
    carries no ``w_step`` (a prepared tree's kernel is the lattice
    already)."""
    k = p[name]["kernel"]
    if expert is not None:
        k = k[expert]
    if quant_mode in ("qat", "packed") and cfg.quant.enabled \
            and "w_step" in p[name]:
        return expert_lattice(k, p[name]["w_step"], cfg)
    return k.to(common.dtype_of(cfg.compute_dtype))


def _maybe_fq_act(x, p, name, cfg, quant_mode):
    """An expert input in the compute dtype, LSQ fake-quantized in f32
    first (midpoint zero point, as the reference) in 'qat' and 'packed'
    modes."""
    if quant_mode in ("qat", "packed") and cfg.quant.enabled \
            and "a_step" in p[name]:
        x = quant.lsq_fake_quant(x.to(torch.float32), p[name]["a_step"],
                                 cfg.quant.a_bits, True)
    return x.to(common.dtype_of(cfg.compute_dtype))


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: [..., n], all zeros for an index outside [0, n)
    (the einsum path marks dropped slots -1).  A comparison, so it never
    checks its indices on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_probs(p, cfg, x):
    """Top-k routing.  x: [T, d] -> (probs [T, k] renormalized over the
    chosen experts, expert ids [T, k] int64, Shazeer's load-balancing aux
    loss), in f32.

    ``torch.topk`` stands in for ``jax.lax.top_k``: both return the k
    largest probabilities in descending order, but where two are equal
    ``lax.top_k`` puts the lower expert id first and ``torch.topk`` leaves
    the order unspecified, so tied routings may differ (the tests draw
    tie-free inputs)."""
    logits = x.to(torch.float32) @ p["router"]["kernel"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = _one_hot(top_i[:, 0], cfg.num_experts, torch.float32).mean(dim=0)
    aux = cfg.num_experts * (me * ce).sum()
    return top_p, top_i, aux


def _whole(p) -> bool:
    """Whether the experts' kernels go through the fake quant as whole
    tensors: only where autograd records through them (LSQ's step
    gradient is scaled by the tensor's size); otherwise one expert at a
    time, with bit-identical values."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for name in ("up", "gate", "down")
        for t in p[name].values())


def _experts(p, cfg, x, quant_mode, mm):
    """The SwiGLU experts over ``x`` with the product ``mm(lhs, kernel)``,
    where ``kernel(e)`` gives expert e's kernel ([E, ...] for None):
    activations fake-quantized before up / gate and before down."""
    def kernel(name):
        return lambda e=None: _expert_kernel(p, name, cfg, quant_mode, e)

    xin = _maybe_fq_act(x, p, "up", cfg, quant_mode)
    up = mm(xin, kernel("up"))
    gate = mm(xin, kernel("gate"))
    h = gate * mlp._sigmoid(gate) * up
    h = _maybe_fq_act(h, p, "down", cfg, quant_mode)
    return mm(h, kernel("down"))


def moe_apply_einsum(p, cfg, x, *, quant_mode="none"):
    """Capacity-dispatch path.  x: [B, S, d] -> ([B, S, d], aux loss).

    Tokens are blocked into groups of ``g`` (``moe_group_size``, decreased
    until it divides the token count); each expert takes ``cap = max(ceil(g
    k cf / E), k)`` (token, choice) pairs a group, queued token-major then
    choice-minor, and the pairs past ``cap`` are dropped (their tokens get
    nothing from that expert).  Dispatch and combine are one-hot tensors
    in the compute dtype, with at most one nonzero per slot, so dispatch is
    exact; the combine sums a token's (at most k) products in f32 -- each
    product of two compute-dtype values is exact there -- and rounds once
    to the compute dtype, as XLA's dot accumulates it."""
    b, s, d = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_i, aux = router_probs(p, cfg, xt)

    g = max(1, min(cfg.moe_group_size, t))
    while t % g:
        g -= 1
    ng = t // g
    cap = int(np.ceil(g * k * cfg.capacity_factor / e))
    cap = max(cap, k)

    with torch.profiler.record_function("moe_dispatch"):
        # position of each (token, choice) in its expert's queue, per group
        oh = _one_hot(top_i, e, torch.int32).reshape(ng, g, k, e)
        pos = torch.cumsum(oh.reshape(ng, g * k, e), dim=1) - 1
        pos = pos.reshape(ng, g, k, e)
        keep = (pos < cap) & (oh > 0)
        disp = (_one_hot(torch.where(keep, pos, -1), cap, cd)
                * oh[..., None].to(cd))                  # [ng,g,k,E,cap]
        dispatch = disp.sum(dim=2)                       # [ng,g,E,cap]
        probs = top_p.reshape(ng, g, k).to(cd)
        combine = (disp * probs[..., None, None]).sum(dim=2)
        xg = xt.reshape(ng, g, d).to(cd)
        expert_in = torch.einsum("ngec,ngd->necd", dispatch, xg)

    whole = _whole(p)

    def mm(lhs, kernel):                # [ng,E,cap,din] x [E,din,dout]
        if whole:
            w = kernel()
            with torch.profiler.record_function("expert_gemm"):
                return torch.einsum("necd,edf->necf", lhs, w)
        out = []
        for i in range(e):
            w = kernel(i)
            with torch.profiler.record_function("expert_gemm"):
                out.append(torch.matmul(lhs[:, i], w))
        return torch.stack(out, dim=1)

    out = _experts(p, cfg, expert_in, quant_mode, mm)     # [ng,E,cap,d]
    with torch.profiler.record_function("moe_combine"):
        y = torch.einsum("ngec,necd->ngd", combine.to(torch.float32),
                         out.to(torch.float32)).to(cd)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_apply_ragged(p, cfg, x, *, quant_mode="none"):
    """Dropless path: (token, choice) pairs sorted by expert (stable), one
    product a group -- the reference's ``jax.lax.ragged_dot`` as one
    ``torch.matmul`` an expert -- and the weighted outputs added back per
    token in the compute dtype.  The group sizes are read on the host."""
    b, s, d = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    t, k = b * s, cfg.num_experts_per_tok
    xt = x.reshape(t, d)
    top_p, top_i, aux = router_probs(p, cfg, xt)

    flat_e = top_i.reshape(-1)                            # [t*k]
    order = torch.argsort(flat_e, stable=True)
    tok_of = order // k
    sorted_x = xt[tok_of].to(cd)
    sizes = torch.bincount(flat_e, minlength=cfg.num_experts).tolist()

    whole = _whole(p)

    def mm(lhs, kernel):                 # [t*k, din] x [E, din, dout]
        parts = torch.split(lhs, sizes)
        ws = kernel() if whole else None
        out = []
        for i, part in enumerate(parts):
            w = ws[i] if whole else kernel(i)
            with torch.profiler.record_function("expert_gemm"):
                out.append(torch.matmul(part, w))
        return torch.cat(out)

    out = _experts(p, cfg, sorted_x, quant_mode, mm)      # [t*k, d]
    w = top_p.reshape(-1)[order][:, None].to(cd)
    y = torch.zeros((t, d), dtype=cd, device=x.device).index_add_(
        0, tok_of, out * w)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_apply(p, cfg, x, *, quant_mode="none", path="einsum"):
    if path == "ragged":
        return moe_apply_ragged(p, cfg, x, quant_mode=quant_mode)
    return moe_apply_einsum(p, cfg, x, quant_mode=quant_mode)
