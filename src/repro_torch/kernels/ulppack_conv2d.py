"""K5: the channel-packed ULPPACK conv2d, and K6: the unpacked integer conv2d
(the paper's int16 baseline).

Replaces ``repro/kernels/ulppack_conv2d.py``: ``ulppack_conv2d`` (Pallas
``_kernel``) and ``int_conv2d`` (``_int_kernel``), both launched by
``_tiled_conv_call`` (pallas_call at :148).  The plan picks K5's kernel
(``plan.route``, ``plan.packed_conv2d_on_tensor_cores``): every shape of
every feasible layout takes ``csrc/ulppack_conv2d_mma.cu`` on the int8
tensor cores, an implicit GEMM of u8 x u8 ``mma.sync`` products over
lattice bytes -- the weight block resident in shared memory where it fits
beside the halo ring, else channel chunks of K streamed through the ring
with the halo.  ``int16xP2s8`` and ``int32xP4s8`` pixels read as bytes are
the lattice; every other layout's are staged raw and rewritten as lattice
bytes in shared memory.  One launch a call, with the CNN's affine dequant
fused in on request (:class:`ConvAffine`).

K6 takes ``csrc/int_conv2d_mma.cu`` on the int8 tensor cores at every
shape, K5's pixel tile (``csrc/conv_mma.cuh``) with each int16 operand
split into a signed high and an unsigned low byte plane, four MMAs a step
at int16 x int16.

The CUDA-core tiles (``csrc/ulppack_conv2d.cu``, ``csrc/int_conv2d.cu``
over ``csrc/conv2d_tile.cuh``: 32-bit integer registers, the faithful
``vmacsr``) stay callable through :func:`ulppack_conv2d_cuda` and
:func:`int_conv2d_cuda` as the comparison the tensor-core rows are timed
against; no plan routes there.

Layouts are the reference's: input NHWC (K5: channels packed into Cp
lanes), weights HWIO (K5: field-reversed lanes [Fh, Fw, Cp, Co], or with
``weight_store='dense'`` bit-dense int32 words [Fh, Fw, ceil(Cin/per),
Co], per = 32 // w_bits), output int32 NHWC.  'SAME' pads (f-1)//2 before
and the rest after, on each spatial axis; the kernels read out-of-range
pixels as zero instead of materialising the padded copy, which is
bit-equal (a zero lane contributes zero).

:func:`ulppack_conv2d_torch` and :func:`int_conv2d_torch` are the plain
PyTorch versions (the CPU path and the on-card comparison).  CUDA PyTorch
has no integer matmul or conv, so they contract shifted windows with
``packing.tile_dots`` (on CUDA exact float64 or int64 products, low 32
bits kept), a
chunk of output rows at a time.  ``kernel_launches`` counts each CUDA
kernel's launches (the tensor-core K5 / K6 as ``ulppack_conv2d_mma`` /
``int_conv2d_mma``, the CUDA-core ones as ``ulppack_conv2d`` /
``int_conv2d``), ``mma_launches`` the tensor-core K5's by epilogue, and
``plain_calls`` each plain version's calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.packing import PackSpec
from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.quant_pack import _as_device_scalar

NAMES = ("ulppack_conv2d", "int_conv2d")

#: Launches of each CUDA kernel / calls of each plain version in this
#: process, keyed by kernel name.
kernel_launches = dict.fromkeys(
    NAMES + ("ulppack_conv2d_mma", "int_conv2d_mma"), 0)
plain_calls = dict.fromkeys(NAMES, 0)
#: Launches of the tensor-core K5 in this process, keyed by epilogue.
mma_launches = {"s32": 0, "affine": 0}

#: int64 bytes one contraction of the plain versions may hold on the card.
_PLAIN_BUDGET = 1 << 28

_launch: dict = {}


def reset_counts():
    for counts in (kernel_launches, plain_calls, mma_launches):
        for k in counts:
            counts[k] = 0


def expand_dense_taps(words: torch.Tensor, spec: PackSpec, cin: int
                      ) -> torch.Tensor:
    """Bit-dense conv words [Fh, Fw, ceil(cin/per), Co] -> P1 lanes
    [Fh, Fw, cp, Co], cp = ceil(cin / n_pack): the inverse of
    ``ops.dense_store_conv_weights`` followed by P1 packing."""
    per = 32 // spec.w_bits
    mask = (1 << spec.w_bits) - 1
    fh, fw, cwords, co = words.shape
    parts = [(words >> (spec.w_bits * j)) & mask for j in range(per)]
    lat = torch.stack(parts, dim=3).reshape(fh, fw, cwords * per, co)
    cp = -(-cin // spec.n_pack)
    # dense_store pads cin -> cwords*per with zero lattice values, and
    # cwords*per >= cp*n_pack always (per >= n_pack), so this slice is the
    # zero-padded lattice pack_weights would have produced.
    lat = lat[:, :, :cp * spec.n_pack, :].reshape(fh, fw, cp, spec.n_pack, co)
    lanes = torch.zeros((fh, fw, cp, co), dtype=torch.int32,
                        device=words.device)
    for j in range(spec.n_pack):
        lanes = lanes + (lat[:, :, :, j, :]
                         << (spec.shift * (spec.n_pack - 1 - j)))
    return lanes.to(spec.lane_dtype)


def same_pads(fh: int, fw: int, padding: str) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) zero rows / columns of ``padding``."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding == "SAME":
        ph, pw = fh - 1, fw - 1
        return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _maybe_pad_spatial(q_x: torch.Tensor, fh: int, fw: int, padding: str
                       ) -> torch.Tensor:
    top, bottom, left, right = same_pads(fh, fw, padding)
    if not (top or bottom or left or right):
        return q_x
    return F.pad(q_x, (0, 0, left, right, top, bottom))


def _check_packed(x_packed, w, spec: PackSpec, weight_store, k_full):
    """Validate the operands; returns ``k_full`` for a 'dense' store."""
    if not spec.feasible:
        raise ValueError(f"{spec} outside the overflow-free region")
    if x_packed.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected x [N,H,W,Cp] and w [Fh,Fw,C,Co], got "
                         f"{tuple(x_packed.shape)} and {tuple(w.shape)}")
    if x_packed.dtype != spec.lane_dtype:
        raise TypeError(f"x must be packed to {spec.lane_name}, got "
                        f"{x_packed.dtype}")
    cp, cdim = x_packed.shape[-1], w.shape[2]
    if weight_store == "lanes":
        if w.dtype != spec.lane_dtype or cdim != cp:
            raise ValueError(f"lanes weights {w.dtype} [.., {cdim}, ..] do "
                             f"not match x's {cp} {spec.lane_name} lanes")
        return None
    if weight_store != "dense":
        raise ValueError(f"weight_store must be 'lanes' or 'dense', got "
                         f"{weight_store!r}")
    if k_full is None:
        raise ValueError("weight_store='dense' requires k_full (Cin)")
    per = 32 // spec.w_bits
    if w.dtype != torch.int32 or cdim != -(-k_full // per) \
            or cp != -(-k_full // spec.n_pack):
        raise ValueError(f"dense words {w.dtype} [.., {cdim}, ..] and {cp} "
                         f"lanes do not hold k_full={k_full} channels")
    return k_full


def _tap_rows(x: torch.Tensor, ih: int, iw: int, out_h: int, out_w: int,
              c0: int, c1: int) -> torch.Tensor:
    """The (ih, iw) tap's shifted window of padded x, channels [c0, c1),
    as rows [N * out_h * out_w, c1 - c0]."""
    win = x[:, ih:ih + out_h, iw:iw + out_w, c0:c1]
    return win.reshape(-1, c1 - c0)


def _dots(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [R, k] x w [k, Co] -> int32 [R, Co] wrapping mod 2^32, a chunk
    of rows at a time so a CUDA int64 product stays within budget."""
    r, k = rows.shape
    co = w.shape[-1]
    step = r if not rows.is_cuda else max(1, _PLAIN_BUDGET // (8 * k * co))
    if step >= r:
        return packing.tile_dots(rows[None], w[None])[0]
    return torch.cat([packing.tile_dots(rows[None, r0:r0 + step], w[None])[0]
                      for r0 in range(0, r, step)])


def ulppack_conv2d_torch(x_packed: torch.Tensor, w: torch.Tensor,
                         spec: PackSpec, *, padding: str = "VALID",
                         weight_store: str = "lanes",
                         k_full: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5: [N,H,W,Cp] x [Fh,Fw,Cdim,Co] -> exact
    int32 [N,Ho,Wo,Co].  As the Pallas kernel: per (tap, run of at most
    ``k_tile`` lanes) a packed contraction, then shift-mask extraction."""
    k_full = _check_packed(x_packed, w, spec, weight_store, k_full)
    plain_calls["ulppack_conv2d"] += 1
    if weight_store == "dense":
        w = expand_dense_taps(w, spec, k_full)
    fh, fw, cp, co = w.shape
    x = _maybe_pad_spatial(x_packed, fh, fw, padding)
    n, h, wd, _ = x.shape
    out_h, out_w = h - fh + 1, wd - fw + 1
    acc = torch.zeros((n * out_h * out_w, co), dtype=torch.int32,
                      device=x.device)
    kt = spec.k_tile
    for ih in range(fh):
        for iw in range(fw):
            for c0 in range(0, cp, kt):
                c1 = min(c0 + kt, cp)
                t = _dots(_tap_rows(x, ih, iw, out_h, out_w, c0, c1),
                          w[ih, iw, c0:c1])
                acc += packing.extract_dot(t, spec)
    return acc.reshape(n, out_h, out_w, co)


def int_conv2d_torch(q_x: torch.Tensor, q_w: torch.Tensor, *,
                     padding: str = "VALID") -> torch.Tensor:
    """Plain PyTorch version of K6: integer [N,H,W,C] x [Fh,Fw,C,Co] ->
    int32 [N,Ho,Wo,Co], wrapped mod 2^32 like XLA's s32."""
    _check_int(q_x, q_w)
    plain_calls["int_conv2d"] += 1
    fh, fw, c, co = q_w.shape
    x = _maybe_pad_spatial(q_x, fh, fw, padding)
    n, h, wd, _ = x.shape
    out_h, out_w = h - fh + 1, wd - fw + 1
    acc = torch.zeros((n * out_h * out_w, co), dtype=torch.int64,
                      device=x.device)
    for ih in range(fh):
        for iw in range(fw):
            acc += _dots(_tap_rows(x, ih, iw, out_h, out_w, 0, c),
                         q_w[ih, iw])
    return packing.wrap_i32(acc).reshape(n, out_h, out_w, co)


def _check_int(q_x, q_w):
    if q_x.dim() != 4 or q_w.dim() != 4 or q_x.shape[-1] != q_w.shape[2]:
        raise ValueError(f"expected x [N,H,W,C] and w [Fh,Fw,C,Co], got "
                         f"{tuple(q_x.shape)} and {tuple(q_w.shape)}")
    ok = (torch.int8, torch.int16)
    if q_x.dtype not in ok or q_w.dtype not in ok:
        raise TypeError(f"int_conv2d takes int8 or int16 operands, got "
                        f"{q_x.dtype} x {q_w.dtype}")


def _bound(name: str, n_ptrs: int, n_ints: int):
    if name not in _launch:
        _launch[name] = build.bind(name, f"{name}_launch", n_ptrs, n_ints)
    return _launch[name]


def _cuda_operands(x, w, fn: str):
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{fn} needs both operands on one CUDA device")
    return x.contiguous(), w.contiguous()


def ulppack_conv2d_cuda(x_packed: torch.Tensor, w: torch.Tensor,
                        spec: PackSpec, *, block_h: int, block_co: int,
                        block_c: int, threads: int, smem_bytes: int,
                        padding: str = "VALID",
                        weight_store: str = "lanes",
                        k_full: int | None = None) -> torch.Tensor:
    """Launch the CUDA-core K5 (CUDA tensors); geometry from
    ``packed_conv2d_core_geometry``."""
    k_full = _check_packed(x_packed, w, spec, weight_store, k_full)
    x, w = _cuda_operands(x_packed, w, "ulppack_conv2d_cuda")
    n, h, wd, cp = x.shape
    fh, fw, wc, co = w.shape
    top, bottom, left, right = same_pads(fh, fw, padding)
    out_h, out_w = h + top + bottom - fh + 1, wd + left + right - fw + 1
    out = torch.empty((n, out_h, out_w, co), dtype=torch.int32,
                      device=x.device)
    dense = weight_store == "dense"
    _bound("ulppack_conv2d", 3, 25)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, cp,
        spec.lane_bytes, fh, fw, wc, co, out_h, out_w, top, left,
        spec.k_tile, spec.band, spec.field_mask, int(dense), spec.w_bits,
        spec.n_pack, spec.shift, block_h, block_co, block_c, threads,
        smem_bytes, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_launches["ulppack_conv2d"] += 1
    return out


class ConvAffine(NamedTuple):
    """The affine dequant of ``cnn.conv_epilogue``, fused into the
    tensor-core K5's epilogue:

        out = (a_scale * w_scale) * (acc - w_zp * psum)    in f32,

    one rounding an operation, ``psum`` the activation lattice's patch sums
    (taken in the kernel from an MMA against ones); bit-equal to the eager
    version."""

    a_scale: object               # scalars: 0-dim tensors or numbers
    w_scale: object
    w_zp: object


def ulppack_conv2d_mma_cuda(x_packed: torch.Tensor, w: torch.Tensor,
                            spec: PackSpec, *, plan, padding: str = "VALID",
                            weight_store: str = "lanes",
                            k_full: int | None = None,
                            epilogue: ConvAffine | None = None
                            ) -> torch.Tensor:
    """Launch the tensor-core K5 (CUDA tensors, lanes of any feasible
    layout) with the geometry of ``plan`` (a 'tensor_cores'
    ``plan_packed_conv2d`` for these shapes and layout): the exact int32
    conv [N, Ho, Wo, Co], or with ``epilogue`` the f32 affine dequant of
    ``cnn.conv_epilogue``.  One launch; no fall-back."""
    k_full = _check_packed(x_packed, w, spec, weight_store, k_full)
    if plan.route != "tensor_cores" or plan.spec != spec:
        raise ValueError(f"ulppack_conv2d_mma_cuda needs a 'tensor_cores' "
                         f"plan for {spec}, got route {plan.route!r} for "
                         f"{plan.spec}")
    x, w = _cuda_operands(x_packed, w, "ulppack_conv2d_mma_cuda")
    n, h, wd, cp = x.shape
    fh, fw, wc, co = w.shape
    top, bottom, left, right = same_pads(fh, fw, padding)
    out_h, out_w = h + top + bottom - fh + 1, wd + left + right - fw + 1
    dev = x.device
    if epilogue is None:
        scalars, out_dtype = [], torch.int32
    else:
        scalars = [_as_device_scalar(epilogue.a_scale, torch.float32, dev),
                   _as_device_scalar(epilogue.w_scale, torch.float32, dev),
                   _as_device_scalar(epilogue.w_zp, torch.int32, dev)]
        out_dtype = torch.float32
    out = torch.empty((n, out_h, out_w, co), dtype=out_dtype, device=dev)
    ptrs = [t.data_ptr() for t in scalars] or [0, 0, 0]
    _bound("ulppack_conv2d_mma", 6, 30)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), *ptrs, n, h, wd, cp, fh,
        fw, wc, co, out_h, out_w, top, left, int(weight_store == "dense"),
        spec.w_bits, k_full or 0, spec.max_w * spec.max_a, spec.lane_bytes,
        spec.n_pack, spec.shift, int(epilogue is not None), plan.block_h,
        plan.block_w, plan.block_co, plan.block_c, plan.chunk_c, plan.chunks,
        plan.stages, plan.threads, plan.blocks, plan.smem_bytes,
        dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kernel_launches["ulppack_conv2d_mma"] += 1
    mma_launches["s32" if epilogue is None else "affine"] += 1
    return out


def int_conv2d_cuda(q_x: torch.Tensor, q_w: torch.Tensor, *, block_h: int,
                    block_co: int, block_c: int, threads: int,
                    smem_bytes: int, padding: str = "VALID"
                    ) -> torch.Tensor:
    """Launch the CUDA-core K6 (CUDA tensors); geometry from
    ``int_conv2d_core_geometry``."""
    _check_int(q_x, q_w)
    x, w = _cuda_operands(q_x, q_w, "int_conv2d_cuda")
    n, h, wd, c = x.shape
    fh, fw, _, co = w.shape
    top, bottom, left, right = same_pads(fh, fw, padding)
    out_h, out_w = h + top + bottom - fh + 1, wd + left + right - fw + 1
    out = torch.empty((n, out_h, out_w, co), dtype=torch.int32,
                      device=x.device)
    _bound("int_conv2d", 3, 18)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c,
        x.element_size(), fh, fw, co, w.element_size(), out_h, out_w, top,
        left, block_h, block_co, block_c, threads, smem_bytes,
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_launches["int_conv2d"] += 1
    return out


def int_conv2d_mma_cuda(q_x: torch.Tensor, q_w: torch.Tensor, *, plan,
                        padding: str = "VALID") -> torch.Tensor:
    """Launch the tensor-core K6 (CUDA tensors) with the geometry of
    ``plan`` (a 'tensor_cores' ``plan_int_conv2d`` for these shapes and
    operand widths): int32 [N, Ho, Wo, Co] wrapped mod 2^32.  One launch;
    no fall-back."""
    _check_int(q_x, q_w)
    if plan.route != "tensor_cores" or (plan.x_bytes, plan.w_bytes) != (
            q_x.element_size(), q_w.element_size()):
        raise ValueError(f"int_conv2d_mma_cuda needs a 'tensor_cores' plan "
                         f"for {q_x.dtype} x {q_w.dtype}, got route "
                         f"{plan.route!r} for {plan.x_bytes} x "
                         f"{plan.w_bytes} bytes")
    x, w = _cuda_operands(q_x, q_w, "int_conv2d_mma_cuda")
    n, h, wd, c = x.shape
    fh, fw, _, co = w.shape
    top, bottom, left, right = same_pads(fh, fw, padding)
    out_h, out_w = h + top + bottom - fh + 1, wd + left + right - fw + 1
    out = torch.empty((n, out_h, out_w, co), dtype=torch.int32,
                      device=x.device)
    _bound("int_conv2d_mma", 3, 23)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c,
        x.element_size(), fh, fw, co, w.element_size(), out_h, out_w, top,
        left, plan.block_h, plan.block_w, plan.block_co, plan.block_c,
        plan.chunk_c, plan.chunks, plan.stages, plan.threads, plan.blocks,
        plan.smem_bytes,
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_launches["int_conv2d_mma"] += 1
    return out


def _geometry(plan) -> dict:
    """The conv tile's launch geometry from a plan; the C launcher refuses
    ``threads`` or ``smem_bytes`` that differ from its own."""
    return dict(block_h=plan.block_h, block_co=plan.block_co,
                block_c=plan.block_c, threads=plan.threads,
                smem_bytes=plan.smem_bytes)


@plan_lib.register_backend("packed_conv2d", "torch")
def _packed_conv2d_torch(plan, x_packed, w, padding):
    return ulppack_conv2d_torch(x_packed, w, plan.spec, padding=padding,
                                weight_store=plan.weight_store,
                                k_full=plan.k_full)


@plan_lib.register_backend("packed_conv2d", "cuda")
def _packed_conv2d_cuda(plan, x_packed, w, padding):
    if plan.route == "tensor_cores":
        return ulppack_conv2d_mma_cuda(x_packed, w, plan.spec, plan=plan,
                                       padding=padding,
                                       weight_store=plan.weight_store,
                                       k_full=plan.k_full)
    return ulppack_conv2d_cuda(x_packed, w, plan.spec, **_geometry(plan),
                               padding=padding,
                               weight_store=plan.weight_store,
                               k_full=plan.k_full)


@plan_lib.register_backend("int_conv2d", "torch")
def _int_conv2d_torch(plan, q_x, q_w, padding):
    return int_conv2d_torch(q_x, q_w, padding=padding)


@plan_lib.register_backend("int_conv2d", "cuda")
def _int_conv2d_cuda(plan, q_x, q_w, padding):
    if plan.route == "tensor_cores":
        return int_conv2d_mma_cuda(q_x, q_w, plan=plan, padding=padding)
    return int_conv2d_cuda(q_x, q_w, **_geometry(plan), padding=padding)
