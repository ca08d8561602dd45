"""K2: ULPPACK packed-lane matmul -- the ``vmacsr`` analogue -- and K7: the
unpacked integer matmul.

K2 replaces ``repro/kernels/ulppack_matmul.py:ulppack_matmul`` (Pallas
kernel ``_kernel``, pallas_call at :99): the exact int32 dot of the
lattices behind packed activation lanes a [M, Kp] and field-reversed
weight lanes w [Kp, N].  Every feasible layout runs on the int8 tensor
cores, over K7's tile (``plan.packed_matmul_on_tensor_cores``):

- ``int16xP2s8``, the layout of every shipped W2A2 config:
  ``csrc/ulppack_matmul_mma.cu``.  Each byte of a lane is one lattice
  value, so the dot is two u8 x u8 byte-plane products per lane.
- every other layout (``int8xP2s4``, ``int16xP4s4``, ``int32xP2s8``,
  ``int32xP4s8``, ``int32xP2s16`` -- W4A4's only one):
  ``csrc/ulppack_matmul_mma_lanes.cu``, one library per layout, whose
  staging writes each field of a lane to the plane byte an int16xP2s8
  lane would have put it in, so the MMAs never multiply lanes.

One launch a call (a split-K fix-up in place of a zero fill and atomics),
with the affine epilogue of ``ops.quantized_linear`` fused in on request
(:class:`Affine`).  The same kernel also takes the float activations
themselves and quantizes them as it stages them (K1 folded in,
:func:`quantized_linear_mma_cuda`): ``ops.quantized_linear`` on the card
is then one launch for every layout.  With the bit-dense weight store
(``weight_store='dense'`` plans: int32 words of w_bits 1, 2 or 4) it
stages the words and expands them into the same byte planes
(``csrc/ulppack_matmul_mma_dense.cu``, one library per w_bits, for float
x and int16xP2s8 lanes; the layout's library for its other lanes), so no
store is expanded to lanes on the card.  The CUDA-core kernel
(``csrc/ulppack_matmul.cu``, :func:`ulppack_matmul_cuda`: runs of k_tile
lanes in packed space, then shift-mask extraction) is on no route; it
stays built as a comparison row.

K7 replaces ``repro/kernels/ulppack_matmul.py:int_matmul`` (Pallas kernel
``_int_kernel``, pallas_call at :145): s8/s16 x s8/s16 -> s32, wrapped mod
2^32 like XLA's s32 dot.  The hand-written kernel is ``csrc/int_matmul.cu``
(int8 tensor cores, ``mma.sync`` over the tile of ``csrc/mma_s8.cuh``: the
weight streamed through a ``cp.async`` ring and transposed to K-major in
shared memory, int16 operands as two byte planes, edge tiles masked).

:func:`ulppack_matmul_torch` and :func:`int_matmul_torch` are the plain
PyTorch versions (the CPU path and the on-card comparison);
``kernel_launches`` / ``plain_calls`` count the CUDA-core K2's (the
comparison row) and K7's launches and each plain version's calls, keyed
by kernel name, and ``mma_launches`` the tensor-core K2's over weight
lanes, keyed by route:
lanes in with the s32 dot or the affine epilogue out, or activations in
with the quantize and the affine epilogue fused ("quant_affine"),
``dense_mma_launches`` its launches over the dense store, by the same
routes, and ``library_launches`` all of them by library.
"""

from __future__ import annotations

import contextlib
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
#: Launches of the tensor-core K2 in this process, keyed by route.
mma_launches = {"s32": 0, "affine": 0, "quant_affine": 0}
#: ... and over the bit-dense weight store, by the same routes.
dense_mma_launches = dict(mma_launches)
#: ... and by (library, route): ``ulppack_matmul_mma`` (int16xP2s8
#: lanes), the dense store's one per w_bits (x, or int16xP2s8 lanes, in),
#: and one per other layout (its lanes, x or lanes in, and its activation
#: lanes over the dense store).
library_launches = {(lib, route): 0 for lib in (
    "ulppack_matmul_mma", *build.VARIANTS, *build.LAYOUT_VARIANTS)
    for route in mma_launches}

#: int64 bytes one chunk of the plain int_matmul may hold on the card.
_PLAIN_BUDGET = 1 << 28

_launch: dict = {}


def reset_counts():
    for k in NAMES:
        kernel_launches[k] = plain_calls[k] = 0
    for k in mma_launches:
        mma_launches[k] = dense_mma_launches[k] = 0
    for k in library_launches:
        library_launches[k] = 0


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


def dense_to_lanes(words: torch.Tensor, spec: PackSpec,
                   k_full: int) -> torch.Tensor:
    """The plain expansion of bit-dense weight words [ceil(k_full / per),
    N] (per = 32 // w_bits) to field-reversed lanes [ceil(k_full /
    n_pack), N]: the reference's ``_dense_to_lanes``."""
    _check_words(words, spec, k_full)
    q_w = packing.unpack_words(words, spec.w_bits, k_full, axis=0)
    return packing.pack_weights(q_w, spec, axis=0)


def _check_words(words, spec: PackSpec, k_full: int):
    rows = plan_lib.dense_words(k_full, spec.w_bits)
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[0] != rows:
        raise ValueError(f"the dense store of K = {k_full} at w_bits "
                         f"{spec.w_bits} is int32 words [{rows}, N], got "
                         f"{words.dtype} {tuple(words.shape)}")


def ulppack_matmul_torch(a_packed: torch.Tensor, w_packed: torch.Tensor,
                         spec: PackSpec) -> torch.Tensor:
    """Plain PyTorch version: [M, Kp] x [Kp, N] -> exact int32 [M, N]."""
    _check(a_packed, w_packed, spec)
    plain_calls["ulppack_matmul"] += 1
    return packing.packed_lanes_matmul(a_packed, w_packed, spec)


def ulppack_matmul_cuda(a_packed: torch.Tensor, w_packed: torch.Tensor,
                        spec: PackSpec, *, block_m: int, block_k: int,
                        splits: int) -> torch.Tensor:
    """Launch the CUDA-core K2 (CUDA tensors, one lane dtype; geometry
    from ``plan.packed_matmul_core_geometry``): on no route, the comparison
    row beside the tensor-core K2."""
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

    a_sums: torch.Tensor | None   # [M] or [M, 1] int32 lattice row sums
    #                               (None: the fused quantize sums them)
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
#: The activation dtypes the fused quantize reads (the launcher's a_kind).
_X_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}

#: The tensor-core K2's split-K workspace and tickets, per (device, stream):
#: allocated on first use, grown when a call needs more, the tickets
#: zeroed only then (every launch leaves them at 0).
_workspaces: dict = {}


class Workspace:
    """A split-K workspace and tickets owned by a set of CUDA graphs
    (``launch/steps.graphed_serving_steps``).  Inside :func:`workspace_scope`
    every tensor-core K2 launch uses it in place of the per-stream one.  It
    grows while the graphs' bodies warm up, outside any capture, and is
    then frozen: a capture that would need more raises, so no later capture
    can free or move what an earlier graph replays.  The graphs replay in
    turn on one stream, so they can share it, as eager launches in turn
    share the per-stream one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.work = self.tickets = None
        self.frozen = False

    def get(self, work_len: int, tiles: int):
        grow_work = self.work is None or self.work.numel() < work_len
        grow_tickets = self.tickets is None or self.tickets.numel() < tiles
        if (grow_work or grow_tickets) and self.frozen:
            raise RuntimeError(
                f"the graphs' split-K workspace is frozen; a launch needs "
                f"{work_len} partials and {tiles} tickets: warm every "
                f"graph's body up before the first capture")
        if grow_work:
            self.work = torch.empty(max(work_len, 1), dtype=torch.int32,
                                    device=self.device)
        if grow_tickets:     # zeroed once: every launch leaves them at 0
            self.tickets = torch.zeros(tiles, dtype=torch.int32,
                                       device=self.device)
        return self.work, self.tickets


_scope: list = []


@contextlib.contextmanager
def workspace_scope(ws: Workspace):
    """Launch the tensor-core K2 with ``ws`` as its split-K workspace for
    the duration of the block."""
    _scope.append(ws)
    try:
        yield ws
    finally:
        _scope.pop()


def _workspace(device: torch.device, stream: int, work_len: int,
               tiles: int):
    if _scope:
        ws = _scope[-1]
        if ws.device != device:
            raise ValueError(f"the scoped workspace is on {ws.device}, the "
                             f"launch on {device}")
        return ws.get(work_len, tiles)
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
    tensors a_sums (None when the kernel sums the rows itself), col_sums,
    a_scale, a_zp, w_scale, w_zp and the bias, all on ``dev``), checked
    against what the kernel reads."""
    if ep.out_dtype not in _OUT_KINDS:
        raise TypeError(f"the fused epilogue stores f32, bf16 or f16, not "
                        f"{ep.out_dtype}")
    a_sums = None
    if ep.a_sums is not None:
        a_sums = ep.a_sums.reshape(-1)
        if a_sums.numel() != m or a_sums.dtype != torch.int32:
            raise ValueError(f"a_sums must be int32 with {m} values")
        a_sums = a_sums.contiguous()
    col_sums = ep.col_sums.reshape(-1)
    if col_sums.numel() != n or col_sums.dtype != torch.int32:
        raise ValueError(f"col_sums must be int32 with {n} values")
    tensors = [a_sums, col_sums.contiguous(),
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
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("the epilogue's tensors must be on the operands' "
                         "device")
    return _OUT_KINDS[ep.out_dtype], bias_kind, tensors


def _library(spec: PackSpec, dense: bool, x_in: bool):
    """(library, entry point, its extra int arguments) of the tensor-core
    K2 for ``spec``'s lanes or the dense store, lanes or x in: the dense
    libraries (one per w_bits) take x and int16xP2s8 lanes, the layout's
    own library its other lanes."""
    p2s8 = (spec.lane_name, spec.n_pack, spec.shift) == ("int16", 2, 8)
    if p2s8 or (dense and x_in):
        if dense:
            return (f"ulppack_matmul_mma_w{spec.w_bits}",
                    "ulppack_matmul_mma_dense_launch", (spec.w_bits,))
        return "ulppack_matmul_mma", "ulppack_matmul_mma_launch", ()
    layout = (spec.lane_bytes, spec.n_pack, spec.shift)
    if dense:
        return (build.layout_library(spec),
                "ulppack_matmul_mma_lanes_dense_launch",
                (spec.w_bits, *layout))
    return (build.layout_library(spec), "ulppack_matmul_mma_lanes_launch",
            layout)


def _launch_mma(a, w, m, k, n, plan, dev, *, a_kind=0, k_full=0, qmax=0,
                out_dtype=torch.int32, out_kind=0, bias_kind=0, tensors=()):
    """One launch of the tensor-core K2 (:func:`_library` for the plan's
    layout and weight store) on contiguous operands: a (lanes, or x with
    ``a_kind`` 1-3), w (lanes, or the words of a 'dense' plan) over K =
    ``k`` steps of two lattice values (``plan_lib.mma_k``), the epilogue's
    ``tensors`` (see :func:`_affine_operands`), the split-K workspace and
    tickets of this device and stream."""
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_tiles = -(-n // plan.block_n)
    tiles = n_tiles * -(-m // plan.block_m)
    # the partial dots, and with x each (split, N tile)'s row sums
    work_len = (plan.splits * m * (n + (n_tiles if a_kind else 0))
                if plan.splits > 1 else 0)
    work, tickets = _workspace(dev, stream, work_len, tiles)
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    ptrs += [0] * (7 - len(ptrs))
    lib, entry, extra = _library(plan.spec, plan.weight_store == "dense",
                                 a_kind != 0)
    fn = _launch.get((lib, entry))
    if fn is None:
        fn = _launch[(lib, entry)] = build.bind(lib, entry, 12,
                                                18 + len(extra))
    fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), work.data_ptr(),
       tickets.data_ptr(), *ptrs, m, k, n, k_full, a_kind, qmax, out_kind,
       bias_kind, work.numel(), tickets.numel(), plan.block_m, plan.block_n,
       plan.step_k, plan.block_k, plan.splits, plan.stages, plan.threads,
       plan.smem_bytes, *extra, dev.index or 0, stream)
    library_launches[lib, "quant_affine" if a_kind else
                     "affine" if out_kind else "s32"] += 1
    return out


def _count(plan, route: str):
    """Count one tensor-core K2 launch of ``route`` on ``plan``'s weight
    store."""
    (dense_mma_launches if plan.weight_store == "dense"
     else mma_launches)[route] += 1


def ulppack_matmul_mma_cuda(a_packed: torch.Tensor, w_packed: torch.Tensor,
                            spec: PackSpec, *, plan,
                            epilogue: Affine | None = None) -> torch.Tensor:
    """Launch the tensor-core K2 (CUDA tensors, lanes of any feasible
    layout) with the geometry of ``plan`` (``plan_packed_matmul`` for
    these shapes and weight store): the exact int32 dot [M, N], or with
    ``epilogue`` the affine map of ``ops.quantized_linear`` as
    ``epilogue.out_dtype`` (f32, bf16 or f16).  With a 'dense' plan
    ``w_packed`` is the bit-dense words [ceil(plan.k_full / per), N],
    expanded in the kernel's staging.  One launch; no fall-back."""
    dense = plan.weight_store == "dense"
    if dense:
        _check_words(w_packed, spec, plan.k_full)
        kp = -(-plan.k_full // spec.n_pack)
        if a_packed.dtype != spec.lane_dtype or a_packed.dim() != 2 \
                or a_packed.shape[1] != kp:
            raise ValueError(f"a must be {spec.lane_name} lanes [M, {kp}], "
                             f"got {a_packed.dtype} "
                             f"{tuple(a_packed.shape)}")
    else:
        _check(a_packed, w_packed, spec)
    if plan.op != "packed_matmul" or plan.spec != spec:
        raise ValueError(f"plan {plan.describe()} is not a packed matmul's "
                         f"for {spec}")
    if epilogue is not None and epilogue.a_sums is None:
        raise ValueError("the lanes route needs the activations' row sums")
    if not (a_packed.is_cuda and w_packed.device == a_packed.device):
        raise ValueError("ulppack_matmul_mma_cuda needs both operands on one "
                         "CUDA device")
    a = a_packed.contiguous()
    w = w_packed.contiguous()
    m, kp = a.shape
    n = w.shape[1]
    k_full = plan.k_full if dense else 0
    k = plan_lib.mma_k(kp, spec, plan.k_full if dense else None)
    if epilogue is None:
        out = _launch_mma(a, w, m, k, n, plan, a.device, k_full=k_full)
    else:
        if dense and epilogue.k != k_full:
            raise ValueError(f"the epilogue's K {epilogue.k} is not the "
                             f"plan's {k_full}")
        out_kind, bias_kind, tensors = _affine_operands(epilogue, m, n,
                                                        a.device)
        out = _launch_mma(a, w, m, k, n, plan, a.device, k_full=epilogue.k,
                          out_dtype=epilogue.out_dtype, out_kind=out_kind,
                          bias_kind=bias_kind, tensors=tensors)
    _count(plan, "s32" if epilogue is None else "affine")
    return out


def quantized_linear_mma_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                              col_sums, a_scale, a_zp, w_scale, w_zp,
                              spec: PackSpec, *, plan, bias=None,
                              out_dtype=torch.float32) -> torch.Tensor:
    """``ops.quantized_linear`` in one launch of the tensor-core K2 with K1
    folded into its staging: x [M, K] f32, bf16 or f16 on the card, read
    in its own dtype and quantized per stage into the byte planes the MMAs
    read, its lattice row sums added up on the way, then the affine
    epilogue (:class:`Affine`).  ``w_packed`` [ceil(K / n_pack), N] lanes
    of any feasible layout, or with a 'dense' plan the bit-dense words
    [ceil(K / per), N]; ``plan`` from ``plan_quantized_linear`` for these
    shapes, x's dtype and the weight store.  Bit-equal to K1 on
    ``x.float()`` followed by :func:`ulppack_matmul_mma_cuda` with the
    epilogue, and to the plain version (``ops.quantized_linear`` on the
    'torch' backend).  One launch; no fall-back."""
    if not spec.feasible:
        raise ValueError(f"{spec} outside the overflow-free region")
    if x.dtype not in _X_KINDS or x.dim() != 2:
        raise TypeError(f"x must be float32, bfloat16 or float16 [M, K], got "
                        f"{x.dtype} {tuple(x.shape)}")
    k = x.shape[1]
    if plan.weight_store == "dense":
        _check_words(w_packed, spec, k)
    elif w_packed.dtype != spec.lane_dtype or w_packed.dim() != 2 \
            or w_packed.shape[0] != -(-k // spec.n_pack):
        raise ValueError(f"w_packed must be {spec.lane_name} lanes "
                         f"[{-(-k // spec.n_pack)}, N], got {w_packed.dtype} "
                         f"{tuple(w_packed.shape)}")
    if plan.op != "quantized_linear" or plan.k_full != k \
            or plan.x_bytes != x.element_size() or plan.spec != spec:
        raise ValueError(f"plan {plan.describe()} is not the fused route's "
                         f"for K = {k}, {x.dtype} and {spec}")
    if not (x.is_cuda and w_packed.device == x.device):
        raise ValueError("quantized_linear_mma_cuda needs x and w_packed on "
                         "one CUDA device")
    x = x.contiguous()
    w = w_packed.contiguous()
    m, n = x.shape[0], w.shape[1]
    out_kind, bias_kind, tensors = _affine_operands(
        Affine(None, col_sums, a_scale, a_zp, w_scale, w_zp, k, bias,
               out_dtype), m, n, x.device)
    out = _launch_mma(x, w, m, plan_lib.mma_k(0, spec, k), n, plan,
                      x.device, a_kind=_X_KINDS[x.dtype], k_full=k,
                      qmax=spec.max_a, out_dtype=out_dtype,
                      out_kind=out_kind, bias_kind=bias_kind,
                      tensors=tensors)
    _count(plan, "quant_affine")
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
    if plan.weight_store == "dense":
        w = dense_to_lanes(w, plan.spec, plan.k_full)
    return ulppack_matmul_torch(a2, w, plan.spec)


@plan_lib.register_backend("packed_matmul", "cuda")
def _packed_matmul_cuda(plan, a2, w):
    return ulppack_matmul_mma_cuda(a2, w, plan.spec, plan=plan)


@plan_lib.register_backend("quantized_linear", "cuda")
def _quantized_linear_cuda(plan, x2, w, col_sums, a_scale, a_zp, w_scale,
                           w_zp, *, bias, out_dtype):
    return quantized_linear_mma_cuda(x2, w, col_sums, a_scale, a_zp,
                                     w_scale, w_zp, plan.spec, plan=plan,
                                     bias=bias, out_dtype=out_dtype)


@plan_lib.register_backend("int_matmul", "torch")
def _int_matmul_torch(plan, a2, w):
    return int_matmul_torch(a2, w)


@plan_lib.register_backend("int_matmul", "cuda")
def _int_matmul_cuda(plan, a2, w):
    return int_matmul_cuda(a2, w, plan=plan)
