"""K1: fused runtime quantize + P1 pack + row sums.

Replaces ``repro/kernels/quant_pack.py:quantize_pack`` (Pallas kernel
``_kernel``, pallas_call at :86).  The hand-written kernel is
``csrc/quant_pack.cu``; what bounds it and how it is laid out is noted
there.  (``ops.quantized_linear`` at ``int16xP2s8`` on the card does not
call it: the tensor-core K2 quantizes its activations as it stages them.)
In one pass over float activations x [M, K] (f32, bf16 or f16, read in
their own dtype) it emits

  lanes    [M, ceil(K / n_pack)]  lane dtype  (ascending fields)
  row_sums [M, 1]                 int32      (sum_k q, for the affine
                                              zero-point correction)

with q = clip(round(x / scale) + zp, 0, 2^a_bits - 1), x / scale in f32.
Beside it,
:func:`quantize_pack_torch` is the plain PyTorch version: the CPU path and
the on-card comparison.  ``kernel_launches`` / ``plain_calls`` count the
calls of each, so a run can show which one it went through.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing, quant
from repro_torch.core.packing import PackSpec
from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

#: Launches of the CUDA kernel / calls of the plain version in this process.
kernel_launches = 0
plain_calls = 0

_launch = None


def reset_counts():
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


def quantize_pack_torch(x: torch.Tensor, scale, zero_point, spec: PackSpec):
    """Plain PyTorch version: quantize_affine, pack_activations, row sums.

    x is cast to f32 first, as the reference's kernel does (a bf16 tensor
    divided by an f32 0-dim scale would stay bf16 and round the quotient)."""
    global plain_calls
    plain_calls += 1
    q = quant.quantize_affine(x.to(torch.float32), scale, zero_point,
                              spec.a_bits)
    packed = packing.pack_activations(q, spec, axis=-1)
    return packed, q.sum(dim=-1, keepdim=True, dtype=torch.int32)


def _as_device_scalar(v, dtype, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.tensor(v)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(()).to(device=device, dtype=dtype)


#: The activation dtypes the kernel reads, and its launcher's code for each.
X_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_pack_cuda(x: torch.Tensor, scale, zero_point, spec: PackSpec,
                       *, threads: int = 256):
    """Launch the CUDA kernel on x [M, K] f32, bf16 or f16 (a CUDA
    tensor), read in its own dtype."""
    global kernel_launches, _launch
    if not x.is_cuda:
        raise ValueError("quantize_pack_cuda needs a CUDA tensor")
    if x.dtype not in X_KINDS or x.dim() != 2:
        raise TypeError(f"x must be float32, bfloat16 or float16 [M, K], "
                        f"got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    m, k = x.shape
    kp = -(-k // spec.n_pack)
    s = _as_device_scalar(scale, torch.float32, x.device)
    z = _as_device_scalar(zero_point, torch.int32, x.device)
    lanes = torch.empty((m, kp), dtype=spec.lane_dtype, device=x.device)
    row_sums = torch.empty((m, 1), dtype=torch.int32, device=x.device)
    if m == 0:
        return lanes, row_sums
    if _launch is None:
        _launch = build.bind("quant_pack", "quant_pack_launch", 5, 9)
    _launch(x.data_ptr(), s.data_ptr(), z.data_ptr(), lanes.data_ptr(),
            row_sums.data_ptr(), m, k, kp, X_KINDS[x.dtype],
            spec.lane_bytes, spec.n_pack,
            spec.shift, spec.max_a, threads, x.device.index or 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    kernel_launches += 1
    return lanes, row_sums


@plan_lib.register_backend("quantize_pack", "torch")
def _quantize_pack_torch(plan, x2, scale, zero_point):
    return quantize_pack_torch(x2, scale, zero_point, plan.spec)


@plan_lib.register_backend("quantize_pack", "cuda")
def _quantize_pack_cuda(plan, x2, scale, zero_point):
    return quantize_pack_cuda(x2, scale, zero_point, plan.spec,
                              threads=plan.threads)
