"""K2: ULPPACK packed-lane matmul -- the ``vmacsr`` analogue.

Replaces ``repro/kernels/ulppack_matmul.py:ulppack_matmul`` (Pallas kernel
``_kernel``, pallas_call at :99).  The hand-written kernel is
``csrc/ulppack_matmul.cu`` (CUDA cores, 32-bit integer registers; its
source note says what bounds it and why).  It computes the exact int32 dot
of the lattices behind packed activation lanes a [M, Kp] and field-reversed
weight lanes w [Kp, N]: runs of at most ``k_tile`` lanes are contracted in
packed space, then ``(t >> shift*(n_pack-1)) & field_mask`` is taken and
summed wide.

:func:`ulppack_matmul_torch` is the plain PyTorch version (the CPU path and
the on-card comparison); ``kernel_launches`` / ``plain_calls`` count each.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
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


def _check(a_packed, w_packed, spec: PackSpec):
    if not spec.feasible:
        raise ValueError(f"{spec} outside the overflow-free region")
    if a_packed.dtype != spec.lane_dtype or w_packed.dtype != spec.lane_dtype:
        raise TypeError(
            f"operands must already be packed to {spec.lane_name}, got "
            f"{a_packed.dtype} x {w_packed.dtype}")
    if a_packed.dim() != 2 or w_packed.dim() != 2 \
            or a_packed.shape[1] != w_packed.shape[0]:
        raise ValueError(f"shapes {tuple(a_packed.shape)} x "
                         f"{tuple(w_packed.shape)} do not contract")


def ulppack_matmul_torch(a_packed: torch.Tensor, w_packed: torch.Tensor,
                         spec: PackSpec) -> torch.Tensor:
    """Plain PyTorch version: [M, Kp] x [Kp, N] -> exact int32 [M, N]."""
    global plain_calls
    _check(a_packed, w_packed, spec)
    plain_calls += 1
    return packing.packed_lanes_matmul(a_packed, w_packed, spec)


def ulppack_matmul_cuda(a_packed: torch.Tensor, w_packed: torch.Tensor,
                        spec: PackSpec, *, block_m: int, block_k: int,
                        splits: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors, one lane dtype)."""
    global kernel_launches, _launch
    _check(a_packed, w_packed, spec)
    if not (a_packed.is_cuda and w_packed.device == a_packed.device):
        raise ValueError("ulppack_matmul_cuda needs both operands on one "
                         "CUDA device")
    a = a_packed.contiguous()
    w = w_packed.contiguous()
    m, kp = a.shape
    n = w.shape[1]
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    if _launch is None:
        _launch = build.bind("ulppack_matmul", "ulppack_matmul_launch", 3, 10)
    _launch(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, kp, n,
            spec.lane_bytes, spec.k_tile, spec.band, spec.field_mask,
            block_k, splits, block_m, a.device.index or 0,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernel_launches += 1
    return out


@plan_lib.register_backend("packed_matmul", "torch")
def _packed_matmul_torch(plan, a2, w):
    return ulppack_matmul_torch(a2, w, plan.spec)


@plan_lib.register_backend("packed_matmul", "cuda")
def _packed_matmul_cuda(plan, a2, w):
    return ulppack_matmul_cuda(a2, w, plan.spec, block_m=plan.block_m,
                               block_k=plan.block_k, splits=plan.splits)
