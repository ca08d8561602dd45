"""K2: ULPPACK packed-lane matmul -- the ``vmacsr`` analogue -- and K7: the
unpacked integer matmul.

K2 replaces ``repro/kernels/ulppack_matmul.py:ulppack_matmul`` (Pallas
kernel ``_kernel``, pallas_call at :99): the exact int32 dot of the
lattices behind packed activation lanes a [M, Kp] and field-reversed
weight lanes w [Kp, N].  The layout picks one of two hand-written kernels
(``plan.packed_matmul_on_tensor_cores``):

- ``int16xP2s8``, the layout of every shipped W2A2 config:
  ``csrc/ulppack_matmul_mma.cu`` on the int8 tensor cores, over K7's tile.
  Each byte of a lane is one lattice value, so the dot is two u8 x u8
  byte-plane products per lane; one launch a call (a split-K fix-up in
  place of a zero fill and atomics), with the affine epilogue of
  ``ops.quantized_linear`` fused in on request (:class:`Affine`).
- every other layout: ``csrc/ulppack_matmul.cu`` (CUDA cores, 32-bit
  integer registers), the faithful kernel: runs of at most ``k_tile``
  lanes contracted in packed space, then ``(t >> shift*(n_pack-1)) &
  field_mask`` taken and summed wide.

K7 replaces ``repro/kernels/ulppack_matmul.py:int_matmul`` (Pallas kernel
``_int_kernel``, pallas_call at :145): s8/s16 x s8/s16 -> s32, wrapped mod
2^32 like XLA's s32 dot.  The hand-written kernel is ``csrc/int_matmul.cu``
(int8 tensor cores, ``mma.sync`` over the tile of ``csrc/mma_s8.cuh``: the
weight streamed through a ``cp.async`` ring and transposed to K-major in
shared memory, int16 operands as two byte planes, edge tiles masked).

:func:`ulppack_matmul_torch` and :func:`int_matmul_torch` are the plain
PyTorch versions (the CPU path and the on-card comparison);
``kernel_launches`` / ``plain_calls`` count the CUDA-core K2's and K7's
launches and each plain version's calls, keyed by kernel name, and
``mma_launches`` the tensor-core K2's, keyed by epilogue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import packing
from repro_torch.core.packing import PackSpec
from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.quant_pack import _as_device_scalar

NAMES = ("ulppack_matmul", "int_matmul")

#: Launches of each CUDA kernel / calls of each plain version in this
#: process, keyed by kernel name.
kernel_launches = dict.fromkeys(NAMES, 0)
plain_calls = dict.fromkeys(NAMES, 0)
#: Launches of the tensor-core K2 in this process, keyed by epilogue.
mma_launches = {"s32": 0, "affine": 0}

#: int64 bytes one chunk of the plain int_matmul may hold on the card.
_PLAIN_BUDGET = 1 << 28

_launch: dict = {}


def reset_counts():
    for k in NAMES:
        kernel_launches[k] = plain_calls[k] = 0
    for k in mma_launches:
        mma_launches[k] = 0


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
    _check(a_packed, w_packed, spec)
    plain_calls["ulppack_matmul"] += 1
    return packing.packed_lanes_matmul(a_packed, w_packed, spec)


def ulppack_matmul_cuda(a_packed: torch.Tensor, w_packed: torch.Tensor,
                        spec: PackSpec, *, block_m: int, block_k: int,
                        splits: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors, one lane dtype)."""
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
    fn = _launch.get("ulppack_matmul")
    if fn is None:
        fn = _launch["ulppack_matmul"] = build.bind(
            "ulppack_matmul", "ulppack_matmul_launch", 3, 10)
    fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, kp, n,
            spec.lane_bytes, spec.k_tile, spec.band, spec.field_mask,
            block_k, splits, block_m, a.device.index or 0,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernel_launches["ulppack_matmul"] += 1
    return out


class Affine(NamedTuple):
    """The affine map of ``ops.quantized_linear``, fused into the
    tensor-core K2's epilogue:

        out = (a_scale * w_scale) * (((acc - w_zp * a_sums) - a_zp *
              col_sums) + (k * a_zp) * w_zp) [+ bias], as ``out_dtype``

    in f32, one rounding an operation, bit-equal to the eager version."""

    a_sums: torch.Tensor          # [M] or [M, 1] int32 lattice row sums
    col_sums: torch.Tensor        # [N] int32 lattice column sums
    a_scale: object               # scalars: 0-dim tensors or numbers
    a_zp: object
    w_scale: object
    w_zp: object
    k: int                        # the lattice K (unpadded)
    bias: torch.Tensor | None = None
    out_dtype: torch.dtype = torch.float32


_OUT_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_BIAS_KINDS = {torch.float32: 1, torch.bfloat16: 2}

#: The tensor-core K2's split-K workspace and tickets, per (device, stream):
#: allocated on first use, grown when a call needs more, the tickets
#: zeroed only then (every launch leaves them at 0).
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, work_len: int,
               tiles: int):
    key = (device.index, stream)
    work, tickets = _workspaces.get(key, (None, None))
    if work is None or work.numel() < work_len:
        work = torch.empty(max(work_len, 1), dtype=torch.int32,
                           device=device)
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=device)
    _workspaces[key] = work, tickets
    return work, tickets


def _affine_operands(ep: Affine, m: int, n: int, dev: torch.device):
    """The fused epilogue's launch arguments: (out kind, bias kind, the
    tensors a_sums, col_sums, a_scale, a_zp, w_scale, w_zp and the bias,
    all on ``dev``), checked against what the kernel reads."""
    if ep.out_dtype not in _OUT_KINDS:
        raise TypeError(f"the fused epilogue stores f32, bf16 or f16, not "
                        f"{ep.out_dtype}")
    a_sums, col_sums = ep.a_sums.reshape(-1), ep.col_sums.reshape(-1)
    if a_sums.numel() != m or col_sums.numel() != n \
            or a_sums.dtype != torch.int32 or col_sums.dtype != torch.int32:
        raise ValueError(f"a_sums / col_sums must be int32 with {m} / {n} "
                         f"values")
    tensors = [a_sums.contiguous(), col_sums.contiguous(),
               _as_device_scalar(ep.a_scale, torch.float32, dev),
               _as_device_scalar(ep.a_zp, torch.int32, dev),
               _as_device_scalar(ep.w_scale, torch.float32, dev),
               _as_device_scalar(ep.w_zp, torch.int32, dev)]
    bias_kind = 0
    if ep.bias is not None:
        bias = ep.bias.reshape(-1)
        if bias.numel() != n:
            raise ValueError(f"bias must have {n} values")
        if bias.dtype == torch.float16:        # exact in f32, as in eager
            bias = bias.float()
        if bias.dtype not in _BIAS_KINDS:
            raise TypeError(f"bias must be f32, bf16 or f16, not "
                            f"{bias.dtype}")
        bias_kind = _BIAS_KINDS[bias.dtype]
        tensors.append(bias.contiguous())
    if any(t.device != dev for t in tensors):
        raise ValueError("the epilogue's tensors must be on the operands' "
                         "device")
    return _OUT_KINDS[ep.out_dtype], bias_kind, tensors


def ulppack_matmul_mma_cuda(a_packed: torch.Tensor, w_packed: torch.Tensor,
                            spec: PackSpec, *, plan,
                            epilogue: Affine | None = None) -> torch.Tensor:
    """Launch the tensor-core K2 (CUDA tensors, ``int16xP2s8`` lanes) with
    the geometry of ``plan`` (``plan_packed_matmul`` for these shapes):
    the exact int32 dot [M, N], or with ``epilogue`` the affine map of
    ``ops.quantized_linear`` as ``epilogue.out_dtype`` (f32, bf16 or f16).
    One launch; no fall-back."""
    _check(a_packed, w_packed, spec)
    if not plan_lib.packed_matmul_on_tensor_cores(spec):
        raise ValueError(f"{spec}: the tensor-core K2 takes int16xP2s8 "
                         f"lanes only")
    if not (a_packed.is_cuda and w_packed.device == a_packed.device):
        raise ValueError("ulppack_matmul_mma_cuda needs both operands on one "
                         "CUDA device")
    a = a_packed.contiguous()
    w = w_packed.contiguous()
    m, kp = a.shape
    n = w.shape[1]
    dev = a.device
    if epilogue is None:
        out_kind, bias_kind, tensors = 0, 0, []
        out_dtype, k_full = torch.int32, 0
    else:
        out_kind, bias_kind, tensors = _affine_operands(epilogue, m, n, dev)
        out_dtype, k_full = epilogue.out_dtype, epilogue.k
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = -(-n // plan.block_n) * -(-m // plan.block_m)
    work_len = plan.splits * m * n if plan.splits > 1 else 0
    work, tickets = _workspace(dev, stream, work_len, tiles)
    ptrs = [t.data_ptr() for t in tensors] + [0] * (7 - len(tensors))
    fn = _launch.get("ulppack_matmul_mma")
    if fn is None:
        fn = _launch["ulppack_matmul_mma"] = build.bind(
            "ulppack_matmul_mma", "ulppack_matmul_mma_launch", 12, 16)
    fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), work.data_ptr(),
       tickets.data_ptr(), *ptrs, m, kp, n, k_full, out_kind, bias_kind,
       work.numel(), tickets.numel(), plan.block_m, plan.block_n,
       plan.step_k, plan.block_k, plan.splits, plan.stages, plan.threads,
       plan.smem_bytes, dev.index or 0, stream)
    mma_launches["s32" if epilogue is None else "affine"] += 1
    return out


_INT_DTYPES = (torch.int8, torch.int16)


def _check_int(q_a, q_w):
    if q_a.dtype not in _INT_DTYPES or q_w.dtype not in _INT_DTYPES:
        raise TypeError(f"int_matmul takes int8 / int16 operands, got "
                        f"{q_a.dtype} x {q_w.dtype}")
    if q_a.dim() != 2 or q_w.dim() != 2 or q_a.shape[1] != q_w.shape[0]:
        raise ValueError(f"shapes {tuple(q_a.shape)} x {tuple(q_w.shape)} "
                         f"do not contract")


def int_matmul_torch(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [M, K] x [K, N] int8/int16 -> int32 wrapped
    mod 2^32.  On the CPU an int32 matmul (it wraps, like XLA's s32); CUDA
    PyTorch has no integer matmul, so on the card int64 products are summed
    exactly in chunks of K and the low 32 bits kept."""
    _check_int(q_a, q_w)
    plain_calls["int_matmul"] += 1
    if not q_a.is_cuda:
        return torch.mm(q_a.to(torch.int32), q_w.to(torch.int32))
    m, k = q_a.shape
    n = q_w.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int64, device=q_a.device)
    step = max(1, _PLAIN_BUDGET // max(1, m * n * 8))
    for k0 in range(0, k, step):
        a = q_a[:, k0:k0 + step, None].to(torch.int64)
        acc += (a * q_w[None, k0:k0 + step].to(torch.int64)).sum(dim=1)
    return packing.wrap_i32(acc)


def int_matmul_cuda(q_a: torch.Tensor, q_w: torch.Tensor, *,
                    plan) -> torch.Tensor:
    """Launch K7 (CUDA tensors, int8/int16 operands) with the geometry of
    ``plan`` (``plan_int_matmul`` for these shapes and dtypes)."""
    _check_int(q_a, q_w)
    if not (q_a.is_cuda and q_w.device == q_a.device):
        raise ValueError("int_matmul_cuda needs both operands on one CUDA "
                         "device")
    a = q_a.contiguous()
    w = q_w.contiguous()
    m, k = a.shape
    n = w.shape[1]
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = _launch.get("int_matmul")
    if fn is None:
        fn = _launch["int_matmul"] = build.bind("int_matmul",
                                                "int_matmul_launch", 3, 13)
    fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
       a.element_size(), w.element_size(), plan.block_m, plan.block_n,
       plan.step_k, plan.block_k, plan.splits, plan.stages, plan.threads,
       plan.smem_bytes, a.device.index or 0,
       torch.cuda.current_stream(a.device).cuda_stream)
    kernel_launches["int_matmul"] += 1
    return out


@plan_lib.register_backend("packed_matmul", "torch")
def _packed_matmul_torch(plan, a2, w):
    return ulppack_matmul_torch(a2, w, plan.spec)


@plan_lib.register_backend("packed_matmul", "cuda")
def _packed_matmul_cuda(plan, a2, w):
    if plan_lib.packed_matmul_on_tensor_cores(plan.spec):
        return ulppack_matmul_mma_cuda(a2, w, plan.spec, plan=plan)
    return ulppack_matmul_cuda(a2, w, plan.spec, block_m=plan.block_m,
                               block_k=plan.block_k, splits=plan.splits)


@plan_lib.register_backend("int_matmul", "torch")
def _int_matmul_torch(plan, a2, w):
    return int_matmul_torch(a2, w)


@plan_lib.register_backend("int_matmul", "cuda")
def _int_matmul_cuda(plan, a2, w):
    return int_matmul_cuda(a2, w, plan=plan)
