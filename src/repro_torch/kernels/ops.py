"""Public kernel API: plan-dispatched packed ops + affine-corrected linear
(counterpart of ``repro/kernels/ops.py``).

Every entry point routes through a ``KernelPlan`` (kernels/plan.py): a
caller passes a prebuilt per-layer plan or one is looked up from the
memoized planners for the shape signature and the operand's device.  The
'torch' and 'cuda' implementations are entries in the plan module's
backend registry, registered by the kernel modules.

``backend``:
  'cuda'  -- the hand-written Hopper kernels (CUDA tensors only).
  'torch' -- the plain PyTorch versions.
  'auto'  -- 'cuda' for CUDA tensors, 'torch' for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import packing, quant
from repro_torch.core.packing import PackSpec
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import quant_pack as _quant_pack  # noqa: F401
from repro_torch.kernels import ulppack_conv2d as _conv  # noqa: F401
from repro_torch.kernels import ulppack_matmul as _matmul  # noqa: F401
from repro_torch.kernels.plan import KernelPlan


def packed_matmul(a_packed, w_packed, spec: PackSpec, *,
                  backend: str = "auto", weight_store: str = "lanes",
                  k_full: int | None = None,
                  plan: KernelPlan | None = None) -> torch.Tensor:
    """[.., Kp] x [Kp, N] -> exact int32 dot of the underlying lattices.

    With ``weight_store='dense'`` (or a dense plan) ``w_packed`` is
    bit-dense int32 words [ceil(k_full / per), N] and ``k_full`` the
    unpacked K (default Kp x n_pack)."""
    lead = a_packed.shape[:-1]
    a2 = a_packed.reshape(-1, a_packed.shape[-1])
    if plan is None:
        plan = plan_lib.plan_packed_matmul(
            a2.shape[0], a2.shape[1], w_packed.shape[-1], spec,
            weight_store=weight_store, k_full=k_full, backend=backend,
            device=a2.device)
    out = plan_lib.dispatch(plan, a2, w_packed)
    return out.reshape(*lead, w_packed.shape[-1])


def packed_conv2d(x_packed, w_packed, spec: PackSpec, *,
                  padding: str = "SAME", backend: str = "auto",
                  weight_store: str = "lanes", k_full: int | None = None,
                  plan: KernelPlan | None = None) -> torch.Tensor:
    """Packed conv2d [N,H,W,Cp] x [Fh,Fw,Cdim,Co] -> exact int32 NHWC.

    The weight store and the launch geometry come from the plan.  With
    ``weight_store='dense'`` the weight operand is bit-dense words; pass
    ``k_full`` (= Cin) when it is not a multiple of n_pack (the planner's
    default rounds up, which the zero-padded words make equivalent).  The
    'torch' backend is the counterpart of ``repro``'s 'xla' one, except
    that it extracts after each (tap, run of at most k_tile lanes), as the
    kernel does, where 'xla' extracts once per channel run over all taps
    (ROADMAP.md Queue 3).
    """
    if plan is None:
        plan = plan_lib.plan_packed_conv2d(
            tuple(x_packed.shape), tuple(w_packed.shape), spec,
            padding=padding, backend=backend, weight_store=weight_store,
            k_full=k_full, device=x_packed.device)
    return plan_lib.dispatch(plan, x_packed, w_packed, padding)


def int_conv2d(q_x, q_w, *, padding: str = "VALID", backend: str = "auto",
               plan: KernelPlan | None = None) -> torch.Tensor:
    """Unpacked integer conv2d (int8/int16) [N,H,W,C] x [Fh,Fw,C,Co] ->
    int32 NHWC wrapped mod 2^32: the paper's int16 baseline."""
    if plan is None:
        plan = plan_lib.plan_int_conv2d(tuple(q_x.shape), tuple(q_w.shape),
                                        x_bytes=q_x.element_size(),
                                        w_bytes=q_w.element_size(),
                                        padding=padding, backend=backend,
                                        device=q_x.device)
    return plan_lib.dispatch(plan, q_x, q_w, padding)


def int_matmul(q_a, q_w, *, backend: str = "auto",
               plan: KernelPlan | None = None) -> torch.Tensor:
    """Unpacked integer matmul [.., K] x [K, N] (int8/int16) -> int32
    wrapped mod 2^32: the W8A8 baseline (K7)."""
    lead = q_a.shape[:-1]
    a2 = q_a.reshape(-1, q_a.shape[-1])
    if plan is None:
        plan = plan_lib.plan_int_matmul(
            a2.shape[0], a2.shape[1], q_w.shape[-1],
            a_bytes=a2.element_size(), w_bytes=q_w.element_size(),
            backend=backend, device=a2.device)
    out = plan_lib.dispatch(plan, a2, q_w)
    return out.reshape(*lead, q_w.shape[-1])


def quantize_pack(x, scale, zero_point, spec: PackSpec, *,
                  backend: str = "auto", plan: KernelPlan | None = None):
    """Quantize + P1-pack activations along the last axis; also row sums."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if plan is None:
        plan = plan_lib.plan_quantize_pack(x2.shape[0], x2.shape[1], spec,
                                           backend=backend, device=x2.device)
    packed, rs = plan_lib.dispatch(plan, x2, scale, zero_point)
    return packed.reshape(*lead, packed.shape[-1]), rs.reshape(*lead, 1)


def quantized_linear(x, w_packed, w_col_sums, a_scale, a_zp, w_scale, w_zp,
                     spec: PackSpec, *, bias=None, backend: str = "auto",
                     weight_store: str = "lanes",
                     plan: KernelPlan | None = None,
                     out_dtype=torch.float32):
    """The deployed Sparq linear: runtime pack + packed matmul + dequant.

    x:          [..., K] float activations (f32, bf16 or f16: the lattice is
                quantized from their f32 values, exactly as from
                ``x.float()``)
    w_packed:   [Kp, N] offline-packed weight lanes (field-reversed), or
                [ceil(K / per), N] bit-dense int32 words under
                ``weight_store='dense'`` (per = 32 // w_bits)
    w_col_sums: [N] int32 offline per-column lattice sums
    plan:       from ``plan_quantized_linear`` (looked up when omitted; its
                weight store then is ``weight_store``)
    Returns float [..., N]; equals ``ref.quantized_linear_ref`` to float
    tolerance and its integer core exactly.

    On the 'cuda' backend the plan is the fused route's, for every
    feasible layout: one launch of the tensor-core K2, which reads x in its
    own dtype, quantizes it as it stages it (K1 folded in) and applies the
    affine correction in its epilogue (``ulppack_matmul.Affine``),
    returning ``out_dtype`` bit-equal to the plain version below; it
    writes the layout's weight fields, or the dense store's words, into
    its byte planes as it stages them.  The 'torch' backend runs K1, the
    packed matmul (dense words expanded to lanes, as the reference's
    ``_dense_to_lanes``) and the eager correction.
    """
    k = x.shape[-1]
    lead = x.shape[:-1]
    n = w_packed.shape[-1]
    if plan is None:
        plan = plan_lib.plan_quantized_linear(
            math.prod(lead), k, n, spec, x.dtype, weight_store=weight_store,
            backend=backend, device=x.device)
    if plan.op == "quantized_linear":
        out = plan_lib.dispatch(plan, x.reshape(-1, k), w_packed, w_col_sums,
                                a_scale, a_zp, w_scale, w_zp, bias=bias,
                                out_dtype=out_dtype)
        return out.reshape(*lead, n)
    a_packed, a_sums = quantize_pack(x, a_scale, a_zp, spec,
                                     backend=plan.backend)
    acc = packed_matmul(a_packed, w_packed, spec, plan=plan)
    f32 = torch.float32
    a_zp_f = torch.as_tensor(a_zp).to(f32)
    w_zp_f = torch.as_tensor(w_zp).to(f32)
    corr = (acc.to(f32)
            - w_zp_f * a_sums.to(f32)
            - a_zp_f * w_col_sums.to(f32)
            + k * a_zp_f * w_zp_f)
    out = torch.as_tensor(a_scale).to(f32) * torch.as_tensor(w_scale).to(f32) \
        * corr
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Offline weight preparation
# ---------------------------------------------------------------------------

def prepare_weights(w, w_scale, w_zp, spec: PackSpec, *,
                    weight_store: str = "lanes"):
    """Offline weight path: quantize, pack (field-reversed), column sums.

    ``weight_store='dense'`` stores the lattice bit-dense (int32 words,
    w_bits a value in device memory) instead of as P1 lanes."""
    q_w = quant.quantize_affine(w, w_scale, w_zp, spec.w_bits)
    col_sums = q_w.sum(dim=0, dtype=torch.int32)
    if weight_store == "dense":
        return dense_store_weights(q_w, spec.w_bits), col_sums
    return packing.pack_weights(q_w, spec, axis=0), col_sums


def dense_store_weights(q_w: torch.Tensor, w_bits: int) -> torch.Tensor:
    """[K, N] lattice (< 2^w_bits) -> [ceil(K/per), N] int32 bit-dense."""
    return packing.pack_words(q_w, w_bits, axis=0)


def dense_load_weights(words: torch.Tensor, w_bits: int, k: int
                       ) -> torch.Tensor:
    """Inverse of dense_store_weights -> [K, N] int32 lattice."""
    return packing.unpack_words(words, w_bits, k, axis=0)


def dense_store_conv_weights(q_w: torch.Tensor, w_bits: int) -> torch.Tensor:
    """[Fh, Fw, Cin, Co] lattice -> [Fh, Fw, ceil(Cin/per), Co] int32 words.

    Word-packs the input-channel axis independently per (fh, fw, co) tap,
    the layout the conv kernel's 'dense' prologue expands."""
    return packing.pack_words(q_w, w_bits, axis=2)
