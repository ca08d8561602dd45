"""Ahead-of-time kernel planning + backend registry (counterpart of
``repro/kernels/plan.py``).

A ``KernelPlan`` is a frozen, hashable description of how one op executes:
its backend, ``PackSpec`` and launch geometry, built once per layer shape by
a memoized planner.  Two backends exist for every op:

  'torch' -- the plain PyTorch version (the counterpart of ``repro``'s
             'xla'); it runs on any device and is the CPU path.
  'cuda'  -- the hand-written Hopper kernel (csrc/, built for sm_90a).

``'auto'`` resolves from the operand's device: 'cuda' for a CUDA tensor on
a capability (9, 0) card, 'torch' for a CPU tensor.  A CUDA tensor never
falls back to the plain version on its own; asking for 'torch' there is
explicit (the on-card comparison runs do it).

Launch geometry is sized for Hopper -- enough blocks to cover the card's
SMs, a few KB of shared memory per block -- not for the TPU's VMEM
budget.  This module is its one owner: the heuristics, the candidate grids
the autotuner measures (``packed_matmul_candidates``,
``attention_decode_candidates``, ``packed_conv2d_candidates``) and the
checks a tuned entry must pass before a planner adopts it.  The planners of
K2, K3/K4 and K5 consult the active tuning cache (kernels/autotune.py)
first; an entry that breaks a constraint the C launcher enforces is
ignored with a warning, so a stale cache never reaches a launcher that
would refuse it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import torch

from repro_torch.core.packing import PackSpec

BACKENDS = ("torch", "cuda")
#: Where a plan's geometry came from: the planner's heuristic, or an entry
#: of the active tuning cache (kernels/autotune.py).
PLAN_SOURCES = ("heuristic", "tuned")

#: Blocks per SM the matmul planner aims for when it picks a K split.
_WAVES = 2

#: Threads per block of the CUDA-core packed matmul kernel (kThreads in
#: csrc/ulppack_matmul.cu).
MATMUL_THREADS = 128

#: The int8 tensor-core tile of K7 and of K2 (kBN,
#: kBK, kMaxStages, kSmemMax, kThreads and kPlaneRow in csrc/mma_s8.cuh,
#: kMaxBlockK in csrc/int_matmul.cu; a CPU test holds them equal, and the C
#: launchers refuse a plan that disagrees): output columns per block, K per
#: stage, the cp.async ring's depth at most and the shared memory it may
#: fill, threads per block, K7's K per split at most (its s32 MMA sums stay
#: in range), the bytes of a K-major byte-plane row in shared memory, and
#: the rows of m per block the kernels are built for.
INT_MATMUL_BN = 128
INT_MATMUL_BK = 64
INT_MATMUL_MAX_STAGES = 8
INT_MATMUL_MIN_STAGES = 3
INT_MATMUL_SMEM_MAX = 232448
INT_MATMUL_THREADS = 256
INT_MATMUL_MAX_BLOCK_K = 32768
INT_MATMUL_PLANE_ROW = INT_MATMUL_BK + 16
INT_MATMUL_BLOCK_MS = (8, 16, 32, 64)
#: The fixed cost of a K7 block (its prologue and epilogue), in stages, for
#: the planner's choice of the K split.
_INT_MATMUL_BLOCK_COST = 3
#: K2 on the tile (csrc/ulppack_matmul_mma.cu and, for every other layout,
#: csrc/ulppack_matmul_mma_lanes.cu): K steps per split at most (kMaxBlockK
#: there; a K step is two lattice values, an int16xP2s8 lane, whatever the
#: layout: each adds two u8 x u8 products to one s32 sum, so a split holds
#: at most ``ULPPACK_MMA_MAX_VALUES`` values, 255^2 * 32768 < 2^31).  Its
#: split model, in units of one
#: 8-row block's stage (~0.7 us alone on an H100): a stage's cost by
#: block_m, a block's fixed cost (its first copies' latency, epilogue),
#: and the split-K fix-up's -- 2 plus, per split, the block_m x 128
#: partials that the last block reads back (bm / 32) -- fitted to the
#: split sweep of ``chip_smoke.py --k2-sweep`` (PERF.md).
ULPPACK_MMA_MAX_BLOCK_K = 16384
ULPPACK_MMA_MAX_VALUES = 2 * ULPPACK_MMA_MAX_BLOCK_K
_ULPPACK_MMA_STAGE_COST = {8: 1.0, 16: 1.2, 32: 1.4, 64: 1.8}
_ULPPACK_MMA_BLOCK_COST = 3
#: The fused quantize's stage costs (K1 folded into the tile): a stage also
#: quantizes block_m rows of 128 values, which a 64-row block feels most;
#: fitted to the ``k2-sweep-fused`` lines of the same sweep (PERF.md).
_QUANT_MMA_STAGE_COST = {**_ULPPACK_MMA_STAGE_COST, 64: 2.6}


def _ulppack_mma_split_cost(splits: int, bm: int) -> float:
    return 2 + splits * bm / 32 if splits > 1 else 0

#: The CUDA-core conv tile of csrc/conv2d_tile.cuh, on no route (the
#: comparison the tensor-core K5 / K6 are timed against; PPT, GPR, CPT,
#: FW_MAX and kMaxThreads there; a CPU test holds the two equal, and the C
#: launcher refuses a plan whose threads or shared memory differ from its
#: own):
#: output pixels per thread, pixel groups per tile row, output columns per
#: block, output channels per thread, the widest kernel its register window
#: takes, threads per block at most, and the shared memory a block may use.
CONV_PPT = 8
CONV_GPR = 4
CONV_TILE_W = CONV_PPT * CONV_GPR
CONV_CPT = 4
CONV_FW_MAX = 8
CONV_MAX_THREADS = 256
CONV_SMEM_MAX = 227 * 1024
#: Shared memory the conv planner aims to stay under (two blocks per SM).
_CONV_SMEM_TARGET = 100 * 1024
#: K5 on the int8 tensor cores (csrc/ulppack_conv2d_mma.cu: kConvThreads,
#: kTilePixels, kStages and kConvSmemMax there, and the block_co / block_w
#: cases of its launcher; a CPU test holds them equal, and the launcher
#: refuses a plan that disagrees): threads per block, output pixels per
#: pixel tile (8 warps x 4 row fragments of 16), the ring's slots, the
#: shared memory a block may use, output channels per block, and output
#: columns per tile.  K6 shares the tile.
CONV_MMA_THREADS = 256
CONV_MMA_TILE_PIXELS = 512
CONV_MMA_STAGES = 2
CONV_MMA_SMEM_MAX = 232448
CONV_MMA_BLOCK_COS = (8, 16, 32, 64)
CONV_MMA_BLOCK_WS = (16, 32)
#: K6 on the same tile (csrc/int_conv2d_mma.cu: the block_co cases of its
#: launcher and its max_prod; a CPU test holds them equal, and the
#: launcher refuses a plan that disagrees): output channels per block
#: (three sets of s32 accumulators a warp at int16 x int16 leave the
#: registers two 8-channel groups), and the largest |product| one
#: accumulator takes a channel, by (x_bytes, w_bytes): s8 x s8, u8 x s8,
#: and the two cross terms of int16 x int16 that share one accumulator.
INT_CONV_MMA_BLOCK_COS = (8, 16)
INT_CONV_MMA_MAX_PROD = {(1, 1): 128 * 128, (1, 2): 255 * 128,
                         (2, 1): 255 * 128, (2, 2): 2 * 128 * 255}

#: The attention kernel of csrc/attention_decode.cu (kThreads, kMaxSplits,
#: kMaxQRows, kMaxTile and kSmemMax there; its launcher refuses a plan that
#: breaks them or whose shared memory differs from its own layout): threads
#: per block, splits per (b, kv head) at most (the portable cluster size),
#: query rows per block at most, cache rows per staged tile at most, and
#: the shared memory a block may use.
ATTN_THREADS = 256
ATTN_WARPS = ATTN_THREADS // 32
ATTN_MAX_SPLITS = 8
ATTN_MAX_QROWS = 64
ATTN_MAX_TILE = 128
ATTN_SMEM_MAX = 232448
#: Its tile path (more than 4 query rows a block; kMmaM, kQTerms,
#: kTileMinBlocks and tile_tile_ok there): query rows padded to blocks of
#: the MMA's m16, q held as up to three bf16 terms (planes in shared
#: memory), and the staged tile rows it takes (whole k16 steps of P.V, a
#: power of two of them per warp).
ATTN_MMA_M = 16
ATTN_Q_TERMS = 3
ATTN_TILE_TILES = (128, 64, 32, 16)
#: The shared memory of a Hopper SM and the attention blocks an SM holds
#: at most (the warp path's registers allow three, the tile path's two).
#: The planner splits the cache until every (b, kv head) pair's splits
#: fill one wave of blocks.
_SM_SMEM = 233472
_ATTN_BLOCKS_PER_SM = 3
_ATTN_TILE_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Frozen per-layer execution plan.

    Geometry fields are populated per op (``None`` where not applicable):
      packed_matmul    : block_m (rows per block), splits / block_k (K
                         split count and K steps of two lattice values per
                         split), weight_store ('lanes' or 'dense') and
                         k_full (the dense store's lattice K); the tensor
                         cores' tile: int_matmul's block_n, step_k,
                         stages, threads and smem_bytes
      quantized_linear : the tensor-core K2 with K1 folded in (every
                         layout on the card): packed_matmul's fields for
                         float activation rows, k_full (the lattice K),
                         x_bytes (the activations' element size) and
                         weight_store
      int_matmul       : block_m / block_n (output rows / columns per
                         block), step_k (K per stage), stages, threads,
                         splits / block_k (K split count and K per split),
                         smem_bytes (per block)
      quantize_pack    : threads
      attention_decode : block_k (KV rows per online-softmax group of the
                         plain version; whole pages when paged); the
                         kernel's block_m (query rows per block), splits /
                         split_rows (splits per (b, kv head) and logical
                         rows per split; whole pages when paged),
                         tile_rows (cache rows per staged tile), threads,
                         smem_bytes (per block)
      packed_conv2d /  : block_h (output rows per block), block_co (output
      int_conv2d         channels per block), block_c (channels or lanes
                         staged per pass), threads, smem_bytes (per block),
                         route ('tensor_cores'; 'cuda_cores' only in a
                         plan built by hand for the comparison tile); on the
                         tensor cores block_h x block_w output pixels a
                         tile, block_c staged bytes a pixel, stages (halo
                         ring slots) and blocks (persistent blocks along
                         the pixel tiles), chunk_c / chunks (staged bytes
                         a pixel of one channel chunk of K and the chunks
                         a tile: block_c and 1 where the weights stay
                         resident); packed_conv2d also weight_store and
                         k_full (Cin of a 'dense' store); int_conv2d also
                         x_bytes / w_bytes (the operands' element sizes)
    """

    op: str
    backend: str                      # 'torch' | 'cuda' (never 'auto')
    spec: PackSpec | None = None
    block_m: int | None = None
    block_k: int | None = None
    splits: int | None = None
    threads: int | None = None
    weight_store: str | None = None
    k_full: int | None = None
    block_h: int | None = None
    block_co: int | None = None
    block_c: int | None = None
    smem_bytes: int | None = None
    split_rows: int | None = None
    tile_rows: int | None = None
    block_n: int | None = None
    step_k: int | None = None
    stages: int | None = None
    block_w: int | None = None
    blocks: int | None = None
    x_bytes: int | None = None
    w_bytes: int | None = None
    route: str | None = None
    chunk_c: int | None = None
    chunks: int | None = None
    source: str = "heuristic"         # 'heuristic' | 'tuned'

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unresolved backend {self.backend!r}")
        if self.source not in PLAN_SOURCES:
            raise ValueError(f"unknown plan source {self.source!r}")

    def describe(self) -> dict:
        """Flat report row: op, backend, layout, source and the set
        geometry."""
        row = {"op": self.op, "backend": self.backend,
               "spec": str(self.spec) if self.spec else None,
               "source": self.source}
        for f in ("block_m", "block_k", "splits", "threads", "weight_store",
                  "k_full", "block_h", "block_co", "block_c", "smem_bytes",
                  "split_rows", "tile_rows", "block_n", "step_k",
                  "stages", "block_w", "blocks", "x_bytes", "w_bytes",
                  "route", "chunk_c", "chunks"):
            if getattr(self, f) is not None:
                row[f] = getattr(self, f)
        return row


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

_BACKENDS: dict[tuple[str, str], object] = {}


def register_backend(op: str, backend: str):
    """Decorator: register ``fn(plan, *args)`` as the (op, backend) impl."""
    def deco(fn):
        _BACKENDS[(op, backend)] = fn
        return fn
    return deco


def get_backend(op: str, backend: str):
    try:
        return _BACKENDS[(op, backend)]
    except KeyError:
        known = sorted(k for k in _BACKENDS if k[0] == op)
        raise KeyError(
            f"no backend {backend!r} registered for op {op!r}; "
            f"registered: {known}") from None


def dispatch(plan: KernelPlan, *args, **kwargs):
    """Route a call through the registry according to its plan."""
    return get_backend(plan.op, plan.backend)(plan, *args, **kwargs)


def resolve_backend(backend: str = "auto", device="cpu") -> str:
    """'auto' -> 'cuda' on a Hopper card, 'torch' on the CPU.

    'cuda' on a CPU device and any CUDA card below capability (9, 0) raise:
    the kernels are built for sm_90a only, and nothing falls back."""
    if backend not in ("auto", *BACKENDS):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         f"'torch' or 'cuda'")
    if backend == "torch":
        return "torch"
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "cuda":
            raise ValueError(
                f"the 'cuda' backend needs CUDA tensors, got device {dev}")
        return "torch"
    _check_hopper(dev.index if dev.index is not None
                  else torch.cuda.current_device())
    return "cuda"


@functools.lru_cache(maxsize=None)
def _check_hopper(index: int) -> None:
    """Raise unless card ``index`` is Hopper; asked once per card, since
    the packed ops plan on every call."""
    cap = torch.cuda.get_device_capability(index)
    if cap < (9, 0):
        raise RuntimeError(
            f"the repro_torch kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} has capability {cap}")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point (engine, init, packing, bridge) runs on.

    Entry points default to "cuda"; without a usable CUDA device they raise
    unless the caller asked for the CPU explicitly -- nothing moves to the
    CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _device_key(device) -> str:
    return str(torch.device(device))


@functools.lru_cache(maxsize=None)
def _sm_count(device_key: str) -> int:
    dev = torch.device(device_key)
    if dev.type != "cuda":
        return 132                   # H100 SXM: plans made off-card
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# Planners (memoized: one plan per layer signature per process)
# ---------------------------------------------------------------------------

def _tuned_plan(key: str, heuristic: KernelPlan, adopt) -> KernelPlan:
    """The plan for ``key`` under the active tuning cache: the heuristic's
    plan with the geometry ``adopt(entry)`` derives from the cache's entry
    (``source='tuned'``), or the heuristic's on a miss.  ``adopt`` raises
    KeyError, TypeError or ValueError where the entry is malformed or
    breaks a constraint the launcher enforces; the entry is then ignored
    with a warning."""
    from repro_torch.kernels import autotune   # deferred: it imports plan

    entry = autotune.lookup(key)
    if entry is None:
        return heuristic
    try:
        if not isinstance(entry, dict):
            raise TypeError(f"entry is a {type(entry).__name__}, not a dict")
        geometry = adopt(entry)
    except (KeyError, TypeError, ValueError) as e:
        warnings.warn(f"ignoring autotune entry {key}: {e}", stacklevel=4)
        return heuristic
    return dataclasses.replace(heuristic, **geometry, source="tuned")


def _int(entry: dict, name: str) -> int:
    """An entry's integer field (KeyError when missing, TypeError when not
    an int: 2.0 or "2" is malformed, not a geometry)."""
    v = entry[name]
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError(f"{name} must be an int, got {v!r}")
    return v


def _geometric_counts(top: int) -> list[int]:
    """1 .. ``top`` in steps of about sqrt(2), ``top`` included: the split
    counts the tuners try."""
    out, s = [], 1
    while s < top:
        out.append(s)
        s = max(s + 1, round(s * 1.42))
    return out + [top]

def packed_matmul_on_tensor_cores(spec: PackSpec) -> bool:
    """Whether K2 runs on the int8 tensor cores for this layout: every
    feasible layout of the family.  ``int16xP2s8`` lanes split into byte
    planes as they are; every other layout's fields are written to the same
    plane bytes while they are staged (``LanesW`` / ``LanesA`` in
    csrc/mma_s8.cuh), so the tile multiplies lattice values and never
    lanes.  The CUDA-core kernel (csrc/ulppack_matmul.cu) is on no route."""
    return spec.feasible


def mma_k(kp: int, spec: PackSpec, k_full: int | None = None) -> int:
    """The tensor-core K2's K: K steps of two lattice values (an
    int16xP2s8 lane) -- ceil(k_full / 2) where the lattice K is known (x
    in, or the dense store), else the ``kp`` lanes' kp * n_pack / 2."""
    if k_full is not None:
        return -(-k_full // 2)
    return kp * spec.n_pack // 2


def mma_stage_lanes(spec: PackSpec) -> int:
    """Lanes of ``spec`` in one 64-step stage of the tile (128 lattice
    values): 64 for two fields a lane, 32 for four."""
    return 2 * INT_MATMUL_BK // spec.n_pack


def mma_split_starts(plan: "KernelPlan") -> list[int]:
    """The first lane of each K split of a tensor-core K2 plan, in the
    plan's layout: whole stages, so whole lanes (``block_k`` steps of two
    values a split)."""
    return [z * plan.block_k * 2 // plan.spec.n_pack
            for z in range(plan.splits)]


def mma_a_bytes(spec: PackSpec) -> int:
    """a's staged bytes a K step on the tile for activation lanes of
    ``spec``: two values' share of a lane, 2 x lane bytes / n_pack."""
    return 2 * spec.lane_bytes // spec.n_pack


def lanes_w_tile_bytes(spec: PackSpec) -> int:
    """Bytes of one raw W tile of weight lanes in the tensor-core K2's
    ring: a stage's lanes (:func:`mma_stage_lanes`) x 128 columns."""
    return mma_stage_lanes(spec) * INT_MATMUL_BN * spec.lane_bytes


WEIGHT_STORES = ("lanes", "dense")
#: The weight bit widths the tensor-core K2 expands from the bit-dense
#: store (``DenseW`` in csrc/mma_s8.cuh): a 128-value stage must be whole
#: words of 32 // w_bits values, which w_bits 3 (10 a word) is not.
DENSE_MMA_W_BITS = (1, 2, 4)


def _check_store(weight_store: str, spec: PackSpec, k_full, kp: int):
    """The lattice K of a plan: ``k_full`` (the dense store's unpacked K;
    ``kp * n_pack`` when omitted) or None for lanes."""
    if weight_store not in WEIGHT_STORES:
        raise ValueError(f"weight_store must be 'lanes' or 'dense', got "
                         f"{weight_store!r}")
    if weight_store == "lanes":
        return None
    k = kp * spec.n_pack if k_full is None else int(k_full)
    if not (kp - 1) * spec.n_pack < k <= kp * spec.n_pack:
        raise ValueError(f"k_full {k} does not fill {kp} lanes of "
                         f"{spec.n_pack}")
    return k


def dense_words(k: int, w_bits: int) -> int:
    """Rows of bit-dense int32 words that hold ``k`` lattice values."""
    return -(-k // (32 // w_bits))


def dense_w_tile_bytes(w_bits: int) -> int:
    """Bytes of one raw W tile of the dense store in the tensor-core K2's
    ring: the words of a stage's 2 x 64 lattice values (``2 * kBK // per``
    rows) x 128 columns of 4 bytes."""
    return 2 * INT_MATMUL_BK // (32 // w_bits) * INT_MATMUL_BN * 4


def _check_dense_mma(spec: PackSpec):
    if spec.w_bits not in DENSE_MMA_W_BITS:
        raise NotImplementedError(
            f"the tensor-core K2 expands bit-dense words of w_bits "
            f"{DENSE_MMA_W_BITS} (a 128-value stage in whole words); "
            f"w_bits {spec.w_bits} is still to be ported (ROADMAP.md "
            f"Queue 2, K2)")


def plan_packed_matmul(m: int, kp: int, n: int, spec: PackSpec, *,
                       weight_store: str, k_full: int | None = None,
                       backend: str = "auto", device="cpu",
                       use_tuning_cache: bool = True) -> KernelPlan:
    """Plan a packed-lane matmul [m, kp] x W -> [m, n] (kernel K2).

    ``weight_store`` (required: it decides the W staging) is 'lanes' (W is
    [kp, n] lanes) or 'dense' (W is [ceil(k_full / per), n] bit-dense
    int32 words, per = 32 // w_bits, ``k_full`` the lattice K, default kp
    x n_pack); the plan records both.  Every feasible layout runs on the
    int8 tensor cores over K7's tile, and the plan carries that tile's
    whole geometry: block_m of 8/16/32/64 rows, 128 columns, a ring of
    64-step stages (a K step is two lattice values: ``mma_stage_lanes``
    lanes of the layout a stage) whose slots hold the layout's raw lanes
    or the dense store's words, 256 threads, the shared memory; K
    (:func:`mma_k`) in splits of at most 16384 steps (32768 values, the s32
    range), whole stages; rows and splits from a wave cost model fitted on
    an H100, ``_tile_split``.  ``block_k`` and ``step_k`` count K steps.

    With ``use_tuning_cache`` the active tuning cache's entry for this
    signature (``autotune.matmul_key``) is adopted first, when its
    geometry passes the launcher's constraints (``source='tuned'``)."""
    return _plan_packed_matmul(m, kp, n, spec,
                               resolve_backend(backend, device),
                               _device_key(device), weight_store,
                               _check_store(weight_store, spec, k_full, kp),
                               use_tuning_cache)


def packed_matmul_core_geometry(m: int, kp: int, n: int, spec: PackSpec,
                                device="cpu", splits: int | None = None
                                ) -> dict:
    """block_m, block_k and splits of the CUDA-core K2 kernel
    (csrc/ulppack_matmul.cu), which takes any feasible layout but is on no
    route: it stays built as the comparison row ``chip_smoke.py`` times
    beside the tensor-core K2.  4 or 8 rows a block, 8 bytes of lanes a
    thread, and K split until the grid covers the card twice (or into
    ``splits`` runs).  Any split is exact (each extracted run holds at most
    k_tile lanes); splits longer than k_tile are whole runs, so no split
    adds an extraction."""
    spec.validate()   # beyond-bound layouts are rejected here, not in-kernel
    bm = 4 if m <= 4 else 8
    if splits is None:
        cpt = 8 // spec.lane_bytes           # columns per thread (8-byte load)
        bn = MATMUL_THREADS * cpt
        blocks = -(-n // bn) * -(-m // bm)
        splits = max(1, min(kp, -(-_WAVES * _sm_count(_device_key(device))
                                  // blocks)))
    block_k = -(-kp // max(1, min(kp, splits)))
    if block_k > spec.k_tile:
        block_k = -(-block_k // spec.k_tile) * spec.k_tile
    return dict(block_m=bm, block_k=block_k, splits=-(-kp // block_k))


@functools.lru_cache(maxsize=None)
def _plan_packed_matmul(m, kp, n, spec, backend, device_key, weight_store,
                        k_full, use_tuning_cache=False) -> KernelPlan:
    spec.validate()   # beyond-bound layouts are rejected here, not in-kernel
    if weight_store == "dense" and backend == "cuda":
        _check_dense_mma(spec)
    w_tile = _w_tile(spec, weight_store)
    k = mma_k(kp, spec, k_full)
    a_bytes = mma_a_bytes(spec)
    plan = KernelPlan(op="packed_matmul", backend=backend, spec=spec,
                      weight_store=weight_store, k_full=k_full,
                      **_mma_geometry(m, k, n, _ULPPACK_MMA_STAGE_COST,
                                      a_bytes, device_key, w_tile))
    if not use_tuning_cache:
        return plan
    from repro_torch.kernels import autotune
    return _tuned_plan(autotune.matmul_key(m, kp, n, spec, backend=backend,
                                           weight_store=weight_store),
                       plan, lambda e: _adopt_mma(e, k, a_bytes, w_tile))


def _w_tile(spec: PackSpec, weight_store: str) -> int:
    """The raw W tile bytes of a ring slot: the dense store's words or the
    layout's lanes."""
    return dense_w_tile_bytes(spec.w_bits) if weight_store == "dense" \
        else lanes_w_tile_bytes(spec)


def _mma_geometry(m, k, n, stage_cost, a_bytes, device_key,
                  w_tile=None) -> dict:
    """The tensor-core K2's geometry over K = ``k`` steps: rows, the K
    split by the wave model with ``stage_cost``, and the ring and shared
    memory for a's staged bytes a step (:func:`mma_a_bytes` for lanes, 2 x
    the element size for float x) and W's raw tile (``w_tile`` bytes of
    dense words or lanes)."""
    # rows: the smallest block that holds m, or 16/32-row blocks below it
    # (more blocks, each stage's MMAs and plane split shorter), of those
    # whose ring holds three stages
    block_ms = {b for b in {_block_m_for(m)} | {b for b in (16, 32) if b < m}
                if _ring_fits(b, a_bytes, w_tile)}
    bm, per, _ = _tile_split(m, k, n, block_ms, stage_cost,
                             _ULPPACK_MMA_BLOCK_COST,
                             _ulppack_mma_split_cost,
                             ULPPACK_MMA_MAX_BLOCK_K, device_key)
    return mma_geometry(k, bm, per, a_bytes, w_tile)


def _ring_fits(block_m: int, a_bytes: int, w_tile) -> bool:
    """Whether the tile's ring holds ``INT_MATMUL_MIN_STAGES`` stages at
    ``block_m`` rows (kMinStages in csrc/mma_s8.cuh; the K2 libraries
    build no variant below it): all but 64 rows of f32 x against int32
    lanes of two fields."""
    stages, _ = int_matmul_smem_layout(block_m, a_bytes, 2, w_tile=w_tile,
                                       a_planes=2)
    return stages >= INT_MATMUL_MIN_STAGES


def mma_geometry(k: int, block_m: int, per: int, a_bytes: int,
                 w_tile: int | None = None) -> dict:
    """The tensor-core K2's whole geometry over K = ``k`` steps at
    ``block_m`` rows a block and ``per`` 64-step stages a split: the ring
    and shared memory of :func:`int_matmul_smem_layout` for a's staged
    bytes a step (``a_bytes``), always split into two planes, and W's raw
    tile (``w_tile``; int16xP2s8 lanes when None), and K in ceil(steps /
    per) splits."""
    stages, smem = int_matmul_smem_layout(block_m, a_bytes, 2, w_tile=w_tile,
                                          a_planes=2)
    steps = max(1, -(-k // INT_MATMUL_BK))
    return dict(block_m=block_m, block_n=INT_MATMUL_BN, step_k=INT_MATMUL_BK,
                stages=stages, threads=INT_MATMUL_THREADS,
                block_k=per * INT_MATMUL_BK, splits=-(-steps // per),
                smem_bytes=smem)


def _adopt_mma(entry: dict, k: int, a_bytes: int, w_tile) -> dict:
    """The tensor-core K2's geometry from a tuned entry: block_m one of
    ``INT_MATMUL_BLOCK_MS``, block_k whole 64-step stages of at most
    16384 steps (``ULPPACK_MMA_MAX_VALUES`` lattice values), splits =
    ceil(K steps / stages a split); the ring and shared memory are
    derived, never read from the entry."""
    bm, block_k = _int(entry, "block_m"), _int(entry, "block_k")
    if bm not in INT_MATMUL_BLOCK_MS:
        raise ValueError(f"block_m {bm} is not one of {INT_MATMUL_BLOCK_MS}")
    if block_k < INT_MATMUL_BK or block_k % INT_MATMUL_BK \
            or block_k > ULPPACK_MMA_MAX_BLOCK_K:
        raise ValueError(
            f"block_k {block_k} is not whole 64-lane stages (K steps of "
            f"two values, an int16xP2s8 lane) of at most "
            f"{ULPPACK_MMA_MAX_BLOCK_K}: {2 * block_k} lattice values a "
            f"split against {ULPPACK_MMA_MAX_VALUES} (the s32 range)")
    geo = mma_geometry(k, bm, block_k // INT_MATMUL_BK, a_bytes, w_tile)
    if "splits" in entry and _int(entry, "splits") != geo["splits"]:
        raise ValueError(f"splits {entry['splits']} != {geo['splits']} for "
                         f"block_k {block_k} over K {k}")
    if geo["stages"] < INT_MATMUL_MIN_STAGES \
            or geo["smem_bytes"] > INT_MATMUL_SMEM_MAX:
        raise ValueError(f"block_m {bm} does not fit the shared memory")
    return geo


def packed_matmul_candidates(m: int, kp: int, n: int, spec: PackSpec, *,
                             weight_store: str = "lanes", x_dtype=None,
                             k_full: int | None = None,
                             device="cpu") -> list[dict]:
    """Every geometry the autotuner may try for K2 at [m, kp] x W in
    ``spec`` (the fused route's when ``x_dtype`` is given; ``k_full`` the
    lattice K of x or of a dense store, else kp x n_pack), each one the
    launcher takes: block_m over
    ``INT_MATMUL_BLOCK_MS`` up to the first that holds m x stages a split
    giving 1 .. 256 splits in steps of about sqrt(2) (at most 16384 K
    steps a split)."""
    spec.validate()
    if x_dtype is not None:
        a_bytes, k = 2 * _x_bytes(x_dtype), mma_k(kp, spec, k_full)
    else:
        a_bytes = mma_a_bytes(spec)
        k = mma_k(kp, spec, k_full if weight_store == "dense" else None)
    w_tile = _w_tile(spec, weight_store)
    steps = max(1, -(-k // INT_MATMUL_BK))
    max_per = ULPPACK_MMA_MAX_BLOCK_K // INT_MATMUL_BK
    pers = dict.fromkeys(min(max_per, -(-steps // s))
                         for s in _geometric_counts(steps))
    out = []
    for bm in INT_MATMUL_BLOCK_MS:
        if _ring_fits(bm, a_bytes, w_tile):
            out += [mma_geometry(k, bm, per, a_bytes, w_tile) for per in pers]
        if bm >= m:
            break
    return out


#: The activation dtypes the fused quantize reads (QuantA, csrc/mma_s8.cuh).
QUANT_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def plan_quantized_linear(m: int, k: int, n: int, spec: PackSpec,
                          x_dtype=torch.float32, *, weight_store: str,
                          backend: str = "auto", device="cpu",
                          use_tuning_cache: bool = True) -> KernelPlan:
    """Plan ``ops.quantized_linear`` over x [m, k] of ``x_dtype`` against
    weight lanes [ceil(k / n_pack), n] (``weight_store='lanes'``) or
    bit-dense words [ceil(k / per), n] ('dense'); ``weight_store`` is
    required: it decides the W staging.

    On the 'cuda' backend, for every feasible layout: the fused route, op
    'quantized_linear' -- one launch of the tensor-core K2 that stages x
    and quantizes it into its byte planes (K1 folded in), and stages W as
    the layout's lanes or as words that it expands into the same planes --
    with the tile's geometry for float rows of ``x_dtype`` over K =
    ceil(k / 2) steps (a stage holds 128 values a row, so the ring is
    shallower than for lanes: bf16 at 64 rows fits 5 stages, f32 3), rows
    and splits by :func:`plan_packed_matmul`'s wave model with the
    quantize's stage costs (splits of at most 16384 steps), ``k_full`` =
    k, ``x_bytes`` and the weight store.  The 'torch' backend: the packed
    matmul's plan (K1, K2 and the eager epilogue run apart).
    ``use_tuning_cache`` consults the active tuning cache as
    :func:`plan_packed_matmul` does, under ``autotune.quantized_linear_key``
    for the fused route."""
    backend = resolve_backend(backend, device)
    kp = -(-k // spec.n_pack)
    k_full = _check_store(weight_store, spec, k, kp)
    if backend == "cuda":
        return _plan_quantized_linear(m, k, n, spec, _x_bytes(x_dtype),
                                      _device_key(device), weight_store,
                                      use_tuning_cache)
    return _plan_packed_matmul(m, kp, n, spec, backend, _device_key(device),
                               weight_store, k_full, use_tuning_cache)


def _x_bytes(x_dtype) -> int:
    if x_dtype not in QUANT_X_DTYPES:
        raise TypeError(f"the fused quantize reads float32, bfloat16 or "
                        f"float16 activations, not {x_dtype}")
    return x_dtype.itemsize


@functools.lru_cache(maxsize=None)
def _plan_quantized_linear(m, k, n, spec, x_bytes, device_key,
                           weight_store, use_tuning_cache=False
                           ) -> KernelPlan:
    spec.validate()
    kp = -(-k // spec.n_pack)
    _check_store(weight_store, spec, k, kp)
    if weight_store == "dense":
        _check_dense_mma(spec)
    w_tile = _w_tile(spec, weight_store)
    steps = mma_k(kp, spec, k)
    plan = KernelPlan(op="quantized_linear", backend="cuda", spec=spec,
                      k_full=k, x_bytes=x_bytes, weight_store=weight_store,
                      **_mma_geometry(m, steps, n, _QUANT_MMA_STAGE_COST,
                                      2 * x_bytes, device_key, w_tile))
    if not use_tuning_cache:
        return plan
    from repro_torch.kernels import autotune
    return _tuned_plan(
        autotune.quantized_linear_key(m, k, n, spec, x_bytes,
                                      backend="cuda",
                                      weight_store=weight_store),
        plan, lambda e: _adopt_mma(e, steps, 2 * x_bytes, w_tile))


def plan_quantize_pack(m: int, k: int, spec: PackSpec, *,
                       backend: str = "auto", device="cpu") -> KernelPlan:
    """Plan the fused runtime quantize+pack over [m, k] activations (K1)."""
    return _plan_quantize_pack(m, k, spec, resolve_backend(backend, device))


@functools.lru_cache(maxsize=None)
def _plan_quantize_pack(m, k, spec, backend) -> KernelPlan:
    kp = -(-k // spec.n_pack)
    threads = min(256, max(32, -(-kp // 32) * 32))
    return KernelPlan(op="quantize_pack", backend=backend, spec=spec,
                      threads=threads)


def plan_int_matmul(m: int, k: int, n: int, *, a_bytes: int = 1,
                    w_bytes: int = 1, backend: str = "auto",
                    device="cpu") -> KernelPlan:
    """Plan the unpacked integer matmul [m, k] x [k, n] of ``a_bytes`` /
    ``w_bytes`` operands (1: int8, 2: int16) (K7).

    The Hopper tile replaces the reference's (128, 128, 512) VMEM blocks:
    ``block_m`` rows of m (the smallest of 8/16/32/64 that holds m) by 128
    columns a block, K staged 64 at a time through a ring as deep as the
    shared memory allows; K is split into ``splits`` runs of ``block_k``
    (a multiple of 64, at most 32768), chosen so that the busiest SM
    streams the fewest stages: the blocks are spread over the SMs in whole
    waves, and each block costs its stages plus a fixed
    ``_INT_MATMUL_BLOCK_COST``.  Edge tiles are masked, so no shape is
    padded."""
    return _plan_int_matmul(m, k, n, a_bytes, w_bytes,
                            resolve_backend(backend, device),
                            _device_key(device))


def int_matmul_smem_layout(block_m: int, a_bytes: int, w_bytes: int, *,
                           w_tile: int | None = None,
                           a_planes: int | None = None) -> tuple[int, int]:
    """(ring depth, shared memory) of one block of the int8 tile (K7, and
    the tensor-core K2): the layout of ``stages_for_w`` and
    ``smem_bytes_w`` in csrc/mma_s8.cuh.  Ring slots, each a raw W tile
    ([64, 128] of ``w_bytes``, or ``w_tile`` bytes of the dense store's
    words, :func:`dense_w_tile_bytes`, or of a layout's lanes,
    :func:`lanes_w_tile_bytes`) and block_m raw a rows of 64 K steps of
    ``a_bytes`` (+16 bytes of padding), as many as fit beside two buffers
    of K-major byte planes (``w_bytes`` of W -- two for the dense store's
    and the lanes' hi and lo values --; a's two where ``a_planes`` is 2,
    none where the MMAs read a's int8 rows from the ring; by default a's
    bytes), up to ``INT_MATMUL_MAX_STAGES``.  The fused quantize stages
    two float values a K step: ``a_bytes`` = 2 x their element size."""
    bk, row = INT_MATMUL_BK, INT_MATMUL_PLANE_ROW
    if w_tile is None:
        w_tile = bk * INT_MATMUL_BN * w_bytes
    if a_planes is None:
        a_planes = a_bytes
    stage = w_tile + block_m * (bk * a_bytes + 16)
    planes = w_bytes * INT_MATMUL_BN * row + (
        2 * block_m * row if a_planes >= 2 else 0)
    stages = min(INT_MATMUL_MAX_STAGES,
                 (INT_MATMUL_SMEM_MAX - 2 * planes) // stage)
    return stages, stages * stage + 2 * planes


def _tile_split(m, k, n, block_ms, stage_cost, block_cost, split_cost,
                max_block_k, device_key):
    """(block_m, K steps per split, splits) on the int8 tile: block_m one
    of ``block_ms``; K split into runs of whole 64-deep stages, at most
    ``max_block_k``; chosen so that the busiest SM spends the least time:
    the blocks are spread over the SMs in whole waves, each block costs
    its stages (``stage_cost[block_m]`` each) plus ``block_cost``, and the
    call ``split_cost(splits, block_m)`` more (in stages)."""
    steps = max(1, -(-k // INT_MATMUL_BK))
    sms = _sm_count(device_key)
    max_per = max_block_k // INT_MATMUL_BK

    def cost(choice):
        bm, per = choice
        splits = -(-steps // per)
        blocks = -(-n // INT_MATMUL_BN) * -(-m // bm) * splits
        return (-(-blocks // sms) * (per * stage_cost[bm] + block_cost)
                + split_cost(splits, bm), -per, bm)

    bm, per = min({(bm, min(max_per, -(-steps // s))) for bm in block_ms
                   for s in range(1, min(steps, 4 * sms) + 1)}, key=cost)
    return bm, per, -(-steps // per)


def _block_m_for(m):
    """The smallest of the tile's row counts that holds m."""
    return next((b for b in INT_MATMUL_BLOCK_MS if b >= m),
                INT_MATMUL_BLOCK_MS[-1])


@functools.lru_cache(maxsize=None)
def _plan_int_matmul(m, k, n, a_bytes, w_bytes, backend,
                     device_key) -> KernelPlan:
    if a_bytes not in (1, 2) or w_bytes not in (1, 2):
        raise TypeError(f"int_matmul takes int8 / int16 operands (1 or 2 "
                        f"bytes), got {a_bytes} x {w_bytes} bytes")
    bm = _block_m_for(m)
    bm, per, splits = _tile_split(m, k, n, (bm,), {bm: 1},
                                  _INT_MATMUL_BLOCK_COST, lambda s, b: 0,
                                  INT_MATMUL_MAX_BLOCK_K, device_key)
    stages, smem = int_matmul_smem_layout(bm, a_bytes, w_bytes)
    return KernelPlan(op="int_matmul", backend=backend, block_m=bm,
                      block_n=INT_MATMUL_BN, step_k=INT_MATMUL_BK,
                      stages=stages, threads=INT_MATMUL_THREADS,
                      block_k=per * INT_MATMUL_BK, splits=splits,
                      smem_bytes=smem)


def attention_row_bytes(hd: int, kv_bits: int, cache_dtype=None) -> int:
    """Bytes of one stored cache row (one position, one kv head): int32
    words at 4/2 bits, int8 at 8, else the float cache's dtype (bf16 at
    kv_bits 16 and f32 at 0 unless ``cache_dtype`` says otherwise)."""
    if kv_bits in (4, 2):
        return 4 * -(-hd // (32 // kv_bits))
    if kv_bits == 8:
        return hd
    if cache_dtype is None:
        cache_dtype = torch.bfloat16 if kv_bits == 16 else torch.float32
    return hd * cache_dtype.itemsize


def attention_warp_path(qrows: int, hd: int) -> bool:
    """Whether the kernel takes its warp path (``warp_variant`` in
    csrc/attention_decode.cu): up to 4 query rows a block (decode, and
    GQA groups of up to 4), each warp keeping its own carry for them in
    registers.  Wider blocks take the tile path."""
    return qrows <= 4


def attention_tile_warps(qrows: int, tile: int, hd: int) -> tuple:
    """The tile path's eight warps (``tile_warps`` in
    csrc/attention_decode.cu) as ``(wm, wk, wd, ntw)``: ``wm`` groups of
    one m16 block of query rows (1, 2 or 4; three blocks take four
    groups), each cut into ``wk`` slices of the staged tile's rows (16
    rows at least, the k16 of P.V) and ``wd`` slices of the dims (the
    warps of one key slice compute its scores alike and split the values'
    dims), and ``ntw`` n8 dim tiles a warp's accumulator holds (at most 8,
    or 16 where hd > 128 leaves no warps to split the dims further)."""
    mb = -(-qrows // ATTN_MMA_M)
    wm = 4 if mb == 3 else mb
    nt = 2 * -(-hd // 16)
    wd_min = min(1 << (-(-nt // 8) - 1).bit_length(), ATTN_WARPS // wm)
    wk = min(ATTN_WARPS // wm // wd_min, tile // 16)
    wd = ATTN_WARPS // (wm * wk)
    return wm, wk, wd, -(-nt // wd)


def attention_smem_bytes(qrows: int, tile: int, hd: int, row_bytes: int,
                         table_len: int, split_rows: int) -> int:
    """Shared memory of one attention block, region by region, each rounded
    up to 16 bytes; the staging buffers of K and V rows are one when a
    split is one tile, else two, and ``table_len`` words hold (paged) the
    split's block-table entries and its rows' cells.

    Warp path (``smem_layout`` in csrc/attention_decode.cu): query rows
    padded to a multiple of 4 and dims to 8, f32 rows of q strided by the
    padded dims + 4: scaled q and the block's carry, the staging buffers
    (rows of ``row_bytes`` rounded up to 16), seven per-query-row words,
    the merge weights [ATTN_MAX_SPLITS + 1, rows], the table, each warp's
    carry and, at cluster rank 0, every split's carry.

    Tile path (``tile_layout`` there): query rows padded to m16 blocks and
    dims to 16: q as three bf16 planes (rows strided by the dims + 8), the
    f32 sums of q x hd^-0.5 over each 8 dims, one region that holds the
    staging buffers (rows strided by ``row_bytes`` rounded up to an odd
    multiple of 16) and, after the last tile, the warps' accumulators
    [wk, rows, dims] in f32 (the first of them the block's carry), the k
    and v scales of both buffers, four per-query-row words, the merge
    weights, the warps' m and l, and the table."""
    def a16(n):
        return -(-n // 16) * 16
    nbuf = 2 if split_rows > tile else 1
    if not attention_warp_path(qrows, hd):
        q16 = -(-qrows // ATTN_MMA_M) * ATTN_MMA_M
        hdp = -(-hd // 16) * 16
        wk = attention_tile_warps(qrows, tile, hd)[1]
        parts = (2 * ATTN_Q_TERMS * q16 * (hdp + 8), 4 * q16 * (hdp // 8),
                 max(nbuf * 2 * tile * (a16(row_bytes) | 16),
                     4 * wk * q16 * hdp),
                 4 * 2 * 2 * tile, 4 * 4 * q16,
                 4 * (ATTN_MAX_SPLITS + 1) * q16, 4 * 2 * wk * q16,
                 4 * table_len)
        return sum(a16(n) for n in parts)
    q4 = -(-qrows // 4) * 4
    hdp = -(-hd // 8) * 8
    ld = hdp + 4
    parts = (4 * q4 * ld, 4 * q4 * hdp, 2 * nbuf * tile * a16(row_bytes),
             28 * q4, 4 * (ATTN_MAX_SPLITS + 1) * q4, 4 * table_len,
             4 * 2 * ATTN_WARPS * q4, 4 * ATTN_WARPS * q4 * hdp,
             4 * ATTN_MAX_SPLITS * q4 * (hdp + 2))
    return sum(a16(n) for n in parts)


def plan_attention_decode(b: int, c: int, skv: int, h: int, kvh: int,
                          hd: int, kv_bits: int, *,
                          page_size: int | None = None, cache_dtype=None,
                          backend: str = "auto", device="cpu",
                          use_tuning_cache: bool = True) -> KernelPlan:
    """Plan the flash-decoding read (K3; K4 when ``page_size`` is set).

    ``skv`` is the logical view length (slot extent, or pages x page_size
    for a paged cache); ``cache_dtype`` the float cache's dtype (kv_bits
    0/16; defaults as :func:`attention_row_bytes`).  ``block_k`` is the
    plain version's group: at most 512 rows, and whole pages when paged
    (the reference's ``chunks`` pages per group is ``block_k //
    page_size``).

    The kernel's geometry: a block serves ``block_m`` query rows (every
    one of a kv head's G x C rows, up to 64) over one split of
    ``split_rows`` positions, staged ``tile_rows`` at a time: 32 to 128
    rows so that three blocks fit an SM (warp path, up to 4 query rows;
    32 where none does), or 16 to 128 for two (tile path, on the bf16
    tensor cores; the largest that fits where none does); a split that is
    one tile is staged in a single buffer.  Splits
    (at most 8: one thread-block cluster per (b, kv head, chunk)) grow
    until the blocks fill one wave of the card (the tile path: no more
    than one wave, in the largest tile that allows that many), each a
    whole number of tiles -- and of pages when paged, so K3 and K4 split
    the same rows alike.  The launcher refuses a plan that disagrees with
    the kernel.

    With ``use_tuning_cache`` the active tuning cache's entry under
    ``autotune.attention_decode_key`` -- the logical shape, without the
    page size, so K3 and K4 adopt one entry and split the same rows alike
    -- replaces tile_rows / split_rows / splits when the launcher takes
    them (whole pages when paged)."""
    return _plan_attention_decode(b, c, skv, h, kvh, hd, kv_bits, page_size,
                                  cache_dtype,
                                  resolve_backend(backend, device),
                                  _device_key(device), use_tuning_cache)


def _attention_rows(c: int, h: int, kvh: int, hd: int) -> int:
    """Query rows a block serves (every one of a kv head's G x C rows, up
    to 64); refuses head layouts the kernel does not take."""
    if h % kvh:
        raise ValueError(f"num_heads {h} is not a multiple of kv heads {kvh}")
    if hd > 256:
        raise ValueError(f"head_dim {hd} > 256 is not supported by the "
                         f"attention kernel")
    return max(1, min(c * (h // kvh), ATTN_MAX_QROWS))


def _attention_tiles(qrows: int, hd: int) -> tuple:
    """The staged tile rows each path takes: 32 / 64 / 128 on the warp
    path (4, 8 or 16 rows a warp), 16 .. 128 on the tile path (whole k16
    steps of its P.V, a power of two of them)."""
    return (128, 64, 32) if attention_warp_path(qrows, hd) \
        else ATTN_TILE_TILES


def attention_decode_geometry(b: int, c: int, skv: int, h: int, kvh: int,
                              hd: int, kv_bits: int, *, tile_rows: int,
                              split_rows: int, page_size: int | None = None,
                              cache_dtype=None) -> dict:
    """The kernel's geometry at ``tile_rows`` cache rows a staged tile and
    ``split_rows`` logical rows a split: splits = ceil(rows / split_rows)
    and the shared memory of that layout (paged: with the split's table
    entries and cells).  Raises ValueError where the launcher would refuse
    it: a tile its path does not take, splits past ``ATTN_MAX_SPLITS``, a
    split that is not whole tiles (and whole pages when paged), or a block
    past the shared memory."""
    qrows = _attention_rows(c, h, kvh, hd)
    if tile_rows not in _attention_tiles(qrows, hd):
        raise ValueError(f"tile_rows {tile_rows} is not one of "
                         f"{_attention_tiles(qrows, hd)} at {qrows} query "
                         f"rows")
    span = math.lcm(tile_rows, page_size or 1)
    if split_rows < 1 or split_rows % span:
        raise ValueError(f"split_rows {split_rows} is not whole tiles of "
                         f"{tile_rows}" + (f" and pages of {page_size}"
                                           if page_size else ""))
    rows = max(1, skv)
    splits = -(-rows // split_rows)
    if splits > ATTN_MAX_SPLITS or (splits - 1) * split_rows >= rows:
        raise ValueError(f"{split_rows} rows a split make {splits} splits "
                         f"of {rows} rows (at most {ATTN_MAX_SPLITS}, none "
                         f"empty)")
    table_len = split_rows // page_size + split_rows if page_size else 0
    smem = attention_smem_bytes(qrows, tile_rows, hd,
                                attention_row_bytes(hd, kv_bits, cache_dtype),
                                table_len, split_rows)
    if smem > ATTN_SMEM_MAX:
        raise ValueError(f"{smem} bytes of shared memory at tile {tile_rows}"
                         f", {split_rows} rows a split")
    return dict(block_m=qrows, splits=splits, split_rows=split_rows,
                tile_rows=tile_rows, threads=ATTN_THREADS, smem_bytes=smem)


def attention_decode_candidates(b: int, c: int, skv: int, h: int, kvh: int,
                                hd: int, kv_bits: int, *,
                                page_size: int | None = None,
                                align: int | None = None,
                                cache_dtype=None) -> list[dict]:
    """Every geometry the autotuner may try for K3 (K4 with ``page_size``)
    at this shape, each one its launcher takes: each tile its path takes x
    1 .. ``ATTN_MAX_SPLITS`` splits of whole tiles and whole pages --
    ``page_size`` rows, or for K3 ``align`` rows, the pages K4 will read
    when it adopts K3's entry (K3's shared memory holds no table)."""
    rows = max(1, skv)
    out = {}
    for tile in _attention_tiles(_attention_rows(c, h, kvh, hd), hd):
        span = math.lcm(tile, page_size or align or 1)
        for s in range(1, ATTN_MAX_SPLITS + 1):
            split_rows = -(-(-(-rows // s)) // span) * span
            try:
                out.setdefault((tile, split_rows), attention_decode_geometry(
                    b, c, skv, h, kvh, hd, kv_bits, tile_rows=tile,
                    split_rows=split_rows, page_size=page_size,
                    cache_dtype=cache_dtype))
            except ValueError:
                continue
    return list(out.values())


@functools.lru_cache(maxsize=None)
def _plan_attention_decode(b, c, skv, h, kvh, hd, kv_bits, page_size,
                           cache_dtype, backend, device_key,
                           use_tuning_cache=False) -> KernelPlan:
    qrows = _attention_rows(c, h, kvh, hd)
    if page_size:
        pages = max(1, min(512 // page_size, -(-skv // page_size)))
        block_k = pages * page_size
    else:
        block_k = min(512, max(1, skv))
    nq = c * (h // kvh)
    row_bytes = attention_row_bytes(hd, kv_bits, cache_dtype)

    def smem(tile, split_rows, table_len=0):
        return attention_smem_bytes(qrows, tile, hd, row_bytes, table_len,
                                    split_rows)

    def geometry(tile, split_rows):
        # splits of whole tiles (and pages) until one wave of the blocks
        # the card holds at once -- shared memory (1 KB a block reserved)
        # or the kernel's registers (at most three a SM) permitting
        span = math.lcm(tile, page_size or 1)
        rows = max(1, skv)
        pairs = b * kvh * -(-nq // qrows)
        per_sm = max(1, min(_ATTN_BLOCKS_PER_SM,
                            _SM_SMEM // (smem(tile, split_rows) + 1024)))
        splits = max(1, min(ATTN_MAX_SPLITS, -(-rows // span),
                            -(-per_sm * _sm_count(device_key)
                              // max(1, pairs))))
        split_rows = -(-(-(-rows // splits)) // span) * span
        return -(-rows // split_rows), split_rows

    tiles = _attention_tiles(qrows, hd)
    if attention_warp_path(qrows, hd):
        # 32-, 64- or 128-row tiles (4, 8 or 16 rows a warp), aiming for
        # three blocks a SM.  First choice: the largest tile that is a
        # whole split on its own, staged once; else the largest that fits
        # double-buffered, or the smallest.
        target = ATTN_SMEM_MAX // 3
        choice = None
        for tile in tiles:
            if smem(tile, tile) <= target:
                splits, split_rows = geometry(tile, tile)
                if split_rows == tile:
                    choice = tile, splits, split_rows
                    break
        if choice is None:
            tile = next((t for t in tiles if smem(t, 2 * t) <= target),
                        tiles[-1])
            choice = tile, *geometry(tile, 2 * tile)
    else:
        # as many splits as one wave of two blocks a SM holds, at most
        # ATTN_MAX_SPLITS and never past it (the wave's count rounded
        # down: a second, part-filled wave costs more than longer splits),
        # in the largest tile that still allows them among those whose
        # block fits two a SM (else those that fit at all; else the
        # smallest, with the most splits).  Decode-like blocks (GQA-6/8
        # at C1, few (b, kv head) pairs) get 8 splits of one 64-row tile;
        # stablelm's chunks 2 splits of two 128-row tiles; the encoder's
        # 256 pairs one split.
        rows = max(1, skv)
        pairs = b * kvh * -(-nq // qrows)
        want = max(1, min(ATTN_MAX_SPLITS, _ATTN_TILE_BLOCKS_PER_SM
                          * _sm_count(device_key) // max(1, pairs)))

        def pick(t):
            span = math.lcm(t, page_size or 1)
            per = -(-(-(-rows // min(want, -(-rows // span)))) // span) * span
            return t, -(-rows // per), per
        opts = [pick(t) for t in tiles]
        fit = ([o for o in opts if smem(o[0], o[2]) <= ATTN_SMEM_MAX // 2]
               or [o for o in opts if smem(o[0], o[2]) <= ATTN_SMEM_MAX]
               or opts[-1:])
        choice = next((o for o in fit if o[1] >= want), fit[-1])
    tile, splits, split_rows = choice
    # paged: the split's table entries and one cell per row
    table_len = split_rows // page_size + split_rows if page_size else 0
    if smem(tile, split_rows, table_len) > ATTN_SMEM_MAX:
        raise ValueError(f"attention at hd {hd} with {qrows} query rows per "
                         f"block does not fit the kernel's shared memory "
                         f"({smem(tile, split_rows, table_len)} bytes)")
    plan = KernelPlan(op="attention_decode", backend=backend,
                      block_k=block_k, block_m=qrows, splits=splits,
                      split_rows=split_rows, tile_rows=tile,
                      threads=ATTN_THREADS,
                      smem_bytes=smem(tile, split_rows, table_len))
    if not use_tuning_cache:
        return plan
    from repro_torch.kernels import autotune

    def adopt(e):
        geo = attention_decode_geometry(
            b, c, skv, h, kvh, hd, kv_bits, tile_rows=_int(e, "tile_rows"),
            split_rows=_int(e, "split_rows"), page_size=page_size,
            cache_dtype=cache_dtype)
        if "splits" in e and _int(e, "splits") != geo["splits"]:
            raise ValueError(f"splits {e['splits']} != {geo['splits']}")
        return geo
    return _tuned_plan(autotune.attention_decode_key(
        b, c, skv, h, kvh, hd, kv_bits, backend=backend), plan, adopt)


def _conv_out(h: int, w: int, fh: int, fw: int, padding: str):
    if padding == "SAME":
        return h, w
    if padding == "VALID":
        return h - fh + 1, w - fw + 1
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


#: Output channels a block of the CUDA-core conv tile.
CONV_BLOCK_COS = (8, 16, 32)


def _conv_geometry(n, out_h, out_w, c, fh, fw, co, device_key,
                   bco=None) -> dict:
    """Launch geometry of the conv tile (csrc/conv2d_tile.cuh) on Hopper.

    ``block_co`` output channels (8, 16 or 32: the smallest that holds Co,
    or ``bco``) x ``block_h`` rows x 32 columns per block, ``block_h * GPR
    * block_co / CPT`` threads (at most 256); rows are halved until the
    grid covers the card twice over; ``block_c`` channels are staged per
    pass, halved until the halo tile and the weight block fit ~100 KB of
    shared memory (two blocks per SM)."""
    if fw > CONV_FW_MAX:
        raise ValueError(f"kernel width {fw} > {CONV_FW_MAX}: the conv "
                         f"tile's register window takes {CONV_FW_MAX} taps")
    if bco is None:
        bco = 8 if co <= 8 else 16 if co <= 16 else 32
    elif bco not in CONV_BLOCK_COS:
        raise ValueError(f"block_co {bco} is not one of {CONV_BLOCK_COS}")
    threads_per_row = CONV_GPR * (bco // CONV_CPT)
    bh = min(16, CONV_MAX_THREADS // threads_per_row)

    def blocks(bh):
        return (n * -(-out_h // bh) * -(-out_w // CONV_TILE_W)
                * -(-co // bco))

    def smem(bh, bc):
        xs = bc * (bh + fh - 1) * (CONV_TILE_W + fw - 1)
        return 4 * (-(-xs // 4) * 4 + fh * fw * bc * bco)

    while bh > 1 and (bh >= 2 * max(1, out_h)
                      or blocks(bh) < _WAVES * _sm_count(device_key)):
        bh //= 2
    bc = max(1, min(c, 8))
    while bc > 1 and smem(bh, bc) > _CONV_SMEM_TARGET:
        bc = -(-bc // 2)
    while bh > 1 and smem(bh, bc) > CONV_SMEM_MAX:
        bh //= 2
    if smem(bh, bc) > CONV_SMEM_MAX:
        raise ValueError(f"a {fh}x{fw} kernel does not fit the conv tile's "
                         f"shared memory ({smem(bh, bc)} bytes)")
    return dict(block_h=bh, block_co=bco, block_c=bc,
                threads=bh * threads_per_row, smem_bytes=smem(bh, bc))


def packed_conv2d_on_tensor_cores(spec: PackSpec) -> bool:
    """Whether K5 runs on the int8 tensor cores for this layout: K2's
    predicate (:func:`packed_matmul_on_tensor_cores`), every feasible
    layout, at every conv shape.  ``int16xP2s8`` and ``int32xP4s8``
    activation lanes read as bytes are the u8 lattice in channel order and
    are staged as they are; every other layout's lanes are staged raw and
    rewritten as lattice bytes (:func:`conv_mma_raw_c`)."""
    return packed_matmul_on_tensor_cores(spec)


def _cpad_for(nbytes: int) -> int:
    """``cpad_for`` in csrc/conv_mma.cuh: 32, 64, else a multiple of 128,
    so that a tap is whole k32 steps and the kernels' swizzle stays inside
    a pixel."""
    return 32 if nbytes <= 32 else 64 if nbytes <= 64 \
        else -(-nbytes // 128) * 128


def _chunk_sizes(block_c: int) -> list[int]:
    """The staged sizes below ``block_c`` a channel chunk may take, largest
    first: 32, 64 and the multiples of 128 (``cpad_for``'s values)."""
    return sorted((c for c in range(32, block_c)
                   if c in (32, 64) or c % 128 == 0), reverse=True)


def conv_mma_fold_run(taps: int, c: int, chunk_ch: int, max_prod: int,
                      chunks: int) -> int:
    """``fold_run`` in csrc/conv_mma.cuh: the chunks one run of the
    tensor-core convs' s32 sums spans before they are folded into uint32
    totals -- every chunk where taps * c * max_prod < 2^31 (no fold), else
    the most chunks of ``chunk_ch`` channels whose products stay below
    2^31 (0: one chunk's could reach it).  PTX does not promise that the
    MMA's s32 sums wrap."""
    if taps * c * max_prod < 2**31:
        return chunks
    return (2**31 - 1) // (taps * chunk_ch * max_prod)


def conv_mma_block_c(cp: int, n_pack: int = 2) -> int:
    """Staged lattice bytes a pixel of the tensor-core K5 for ``cp`` lanes
    of ``n_pack`` fields (n_pack cp lattice bytes)."""
    return _cpad_for(n_pack * cp)


def conv_mma_raw_c(cp: int, spec: PackSpec, chunk_c: int | None = None
                   ) -> int:
    """Bytes a pixel of the tensor-core K5's raw slot: 0 where the
    activation lanes read as bytes are the lattice (byte fields, as many
    as the lane has bytes: ``int16xP2s8``, ``int32xP4s8``), else the
    pixel's ``cp`` lanes rounded up to 16 bytes, or with ``chunk_c`` (a
    chunk of several) the lanes of one chunk (``craw`` in
    csrc/ulppack_conv2d_mma.cu)."""
    if spec.shift == 8 and spec.n_pack == spec.lane_bytes:
        return 0
    if chunk_c is not None:
        return chunk_c * spec.lane_bytes // spec.n_pack
    return -(-cp * spec.lane_bytes // 16) * 16


def conv_mma_smem_bytes(fh: int, fw: int, block_h: int, block_w: int,
                        block_co: int, block_c: int, raw_c: int = 0,
                        chunk_c: int | None = None) -> int:
    """Shared memory of one tensor-core K5 block.  One chunk (``chunk_c``
    None or ``block_c``): the resident weight block, ``block_co`` rows of fh
    * fw * block_c bytes + 16 (an odd number of 16-byte units, for
    conflict-free ldmatrix), then ``CONV_MMA_STAGES`` halo slots of (block_h
    + fh - 1) x (block_w + fw - 1) pixels of ``block_c`` bytes.  Several:
    ``CONV_MMA_STAGES`` slots, each one chunk's weight rows (fh * fw *
    chunk_c + 16 bytes) and halo slice (``chunk_c`` bytes a pixel).  Then a
    raw slot of as many pixels of ``raw_c`` bytes (:func:`conv_mma_raw_c`).
    """
    pixels = (block_h + fh - 1) * (block_w + fw - 1)
    if chunk_c is None or chunk_c == block_c:
        krow = fh * fw * block_c + 16
        return block_co * krow + CONV_MMA_STAGES * pixels * block_c \
            + pixels * raw_c
    krow = fh * fw * chunk_c + 16
    return CONV_MMA_STAGES * (block_co * krow + pixels * chunk_c) \
        + pixels * raw_c


def _conv_mma_geometry(n, out_h, out_w, cp, fh, fw, co, spec,
                       device_key, tile=None) -> dict:
    """Launch geometry of the tensor-core K5 (csrc/ulppack_conv2d_mma.cu).

    Pixel tiles of 512 output pixels, 16 x 32 (32 x 16 on images at most
    16 columns wide); ``block_co`` the smallest of 8/16/32/64 output
    channels that holds Co (64 beyond); one block an SM, persistent, each
    walking an equal share of the tiles in whole waves.  Where the resident
    weight block and the halo ring fit the shared memory at some block_co
    (halved from that one) and no sum over all of K can reach 2^31, one
    chunk: chunk_c = block_c.  Else K is split into channel chunks: at the
    largest block_co (halved as needed) the largest ``chunk_c`` (32, 64 or
    a multiple of 128) whose two ring slots of weight rows and halo slice
    fit and whose one-chunk sums stay in range (longer K folds every
    :func:`conv_mma_fold_run` chunks).  ``tile`` = (block_co, block_w)
    asks for that tile instead (the tuner's candidates), refused where the
    launcher would refuse it.  Layouts whose lanes are not lattice bytes
    add a raw slot (:func:`conv_mma_raw_c`).  Raises where no chunk fits
    at 8 channels (kernels of about 20 x 20 and more)."""
    chans = spec.n_pack * cp
    taps = fh * fw
    prod = spec.max_w * spec.max_a
    bc = conv_mma_block_c(cp, spec.n_pack)
    if tile is not None:
        bco, bw = tile
        if bco not in CONV_MMA_BLOCK_COS or bw not in CONV_MMA_BLOCK_WS:
            raise ValueError(f"tile (block_co {bco}, block_w {bw}) is not "
                             f"one of {CONV_MMA_BLOCK_COS} x "
                             f"{CONV_MMA_BLOCK_WS}")
        bh = CONV_MMA_TILE_PIXELS // bw
        cos = [bco]
    else:
        bh, bw = _conv_mma_tile(out_w)
        bco = next((b for b in CONV_MMA_BLOCK_COS if b >= co),
                   CONV_MMA_BLOCK_COS[-1])
        cos = [b for b in CONV_MMA_BLOCK_COS if b <= bco][::-1]

    def smem(bco, chunk):
        raw = conv_mma_raw_c(cp, spec, None if chunk == bc else chunk)
        return conv_mma_smem_bytes(fh, fw, bh, bw, bco, bc, raw, chunk)

    def plan(bco, chunk):
        return dict(route="tensor_cores", block_h=bh, block_w=bw,
                    block_co=bco, block_c=bc, chunk_c=chunk,
                    chunks=-(-chans // chunk),
                    stages=CONV_MMA_STAGES, threads=CONV_MMA_THREADS,
                    blocks=_conv_mma_blocks(n, out_h, out_w, co, bh, bw,
                                            bco, device_key),
                    smem_bytes=smem(bco, chunk))

    if taps * chans * prod < 2**31:
        for b in cos:
            if smem(b, bc) <= CONV_MMA_SMEM_MAX:
                return plan(b, bc)
    for b in cos:
        for chunk in _chunk_sizes(bc):
            if conv_mma_fold_run(taps, chans, chunk, prod,
                                 -(-chans // chunk)) >= 1 \
                    and smem(b, chunk) <= CONV_MMA_SMEM_MAX:
                return plan(b, chunk)
    raise ValueError(f"a {fh}x{fw} kernel does not fit the tensor-core "
                     f"K5's shared memory at {cos[-1]} output channels and "
                     f"32 staged bytes a chunk ({smem(cos[-1], 32)} bytes)")


def _conv_mma_tile(out_w: int) -> tuple[int, int]:
    """(block_h, block_w) of a 512-pixel tile of the tensor-core convs:
    16 x 32, or 32 x 16 on images at most 16 columns wide."""
    bw = CONV_MMA_BLOCK_WS[0] if out_w <= CONV_MMA_BLOCK_WS[0] \
        else CONV_MMA_BLOCK_WS[1]
    return CONV_MMA_TILE_PIXELS // bw, bw


def _conv_mma_blocks(n, out_h, out_w, co, bh, bw, bco, device_key) -> int:
    """Persistent blocks along the pixel tiles: one block an SM over the
    channel blocks, each walking an equal share of the tiles in whole
    waves."""
    tiles = n * -(-out_h // bh) * -(-out_w // bw)
    per_wave = max(1, _sm_count(device_key) // -(-max(co, 1) // bco))
    waves = max(1, -(-tiles // per_wave))
    return max(1, -(-tiles // waves))


def plan_packed_conv2d(x_shape: tuple, w_shape: tuple, spec: PackSpec, *,
                       padding: str = "SAME", backend: str = "auto",
                       weight_store: str = "lanes",
                       k_full: int | None = None, device="cpu",
                       use_tuning_cache: bool = True) -> KernelPlan:
    """Plan a packed conv2d x [N, H, W, Cp] * w [Fh, Fw, Cdim, Co] (K5).

    Records the layout, the weight store and ``k_full`` (Cin of a 'dense'
    store, defaulting to ``cp * n_pack`` as in the reference) beside the
    Hopper launch geometry; the TPU's VMEM budget and ``block_h``
    candidates have no counterpart here.  Every shape takes the
    implicit-GEMM conv on the int8 tensor cores (``route`` 'tensor_cores')
    with ``_conv_mma_geometry``: the weights resident where they fit, else
    channel chunks streamed through the ring.  With ``use_tuning_cache``
    the active tuning cache's entry (``autotune.conv2d_key``) replaces the
    tile, block_co x block_w, where the launcher takes it; an entry
    without that tile (one tuned for the CUDA-core tile) is ignored with a
    warning."""
    return _plan_packed_conv2d(tuple(x_shape), tuple(w_shape), spec, padding,
                               resolve_backend(backend, device), weight_store,
                               k_full, _device_key(device), use_tuning_cache)


def packed_conv2d_candidates(x_shape: tuple, w_shape: tuple,
                             spec: PackSpec, *, padding: str = "SAME",
                             device="cpu") -> list[dict]:
    """Every tile the autotuner may try for K5 at these packed shapes, each
    one the launcher takes: block_co over ``CONV_MMA_BLOCK_COS`` up to the
    first that holds Co x block_w over ``CONV_MMA_BLOCK_WS`` (block_h =
    512 / block_w), each with the chunks ``_conv_mma_geometry`` gives it."""
    n, h, w, cp = x_shape
    fh, fw, _, co = w_shape
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    dk = _device_key(device)
    out = []
    for bco in CONV_MMA_BLOCK_COS:
        for bw in CONV_MMA_BLOCK_WS:
            try:
                out.append(_conv_mma_geometry(n, out_h, out_w, cp, fh, fw,
                                              co, spec, dk, tile=(bco, bw)))
            except ValueError:
                pass
        if bco >= co:
            break
    return out


def packed_conv2d_core_geometry(x_shape: tuple, w_shape: tuple, *,
                                padding: str = "SAME", device="cpu") -> dict:
    """block_h, block_co, block_c, threads and smem_bytes of the CUDA-core
    conv tile (csrc/conv2d_tile.cuh) for these shapes, which takes any
    feasible layout.  No plan routes there: the tile is kept as the
    comparison the tensor-core K5's rows are timed against."""
    n, h, w, cp = x_shape
    fh, fw, _, co = w_shape
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    return _conv_geometry(n, out_h, out_w, cp, fh, fw, co,
                          _device_key(device))


@functools.lru_cache(maxsize=None)
def _plan_packed_conv2d(x_shape, w_shape, spec, padding, backend,
                        weight_store, k_full, device_key,
                        use_tuning_cache=False) -> KernelPlan:
    spec.validate()   # beyond-bound layouts are rejected here, not in-kernel
    if weight_store not in ("lanes", "dense"):
        raise ValueError(f"weight_store must be 'lanes' or 'dense', got "
                         f"{weight_store!r}")
    n, h, w, cp = x_shape
    fh, fw, _, co = w_shape
    if weight_store == "dense" and k_full is None:
        k_full = cp * spec.n_pack
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    geometry = _conv_mma_geometry(n, out_h, out_w, cp, fh, fw, co, spec,
                                  device_key)
    plan = KernelPlan(op="packed_conv2d", backend=backend, spec=spec,
                      weight_store=weight_store, k_full=k_full, **geometry)
    if not use_tuning_cache:
        return plan
    from repro_torch.kernels import autotune

    def adopt(e):
        return _conv_mma_geometry(
            n, out_h, out_w, cp, fh, fw, co, spec, device_key,
            tile=(_int(e, "block_co"), _int(e, "block_w")))
    return _tuned_plan(autotune.conv2d_key(x_shape, w_shape, spec,
                                           padding=padding, backend=backend,
                                           weight_store=weight_store),
                       plan, adopt)


def int_conv_mma_smem_bytes(fh: int, fw: int, block_h: int, block_w: int,
                            block_co: int, c: int, x_bytes: int,
                            w_bytes: int, chunk_c: int | None = None) -> int:
    """Shared memory of one tensor-core K6 block.  One chunk (``chunk_c``
    None or x_bytes * cpc): the resident weight block, ``block_co`` rows of
    fh * fw taps of ``w_bytes`` planes of cpc = ``_cpad_for(c)`` bytes +
    16, then ``CONV_MMA_STAGES`` halo slots of (block_h + fh - 1) x
    (block_w + fw - 1) pixels of ``x_bytes`` planes of cpc bytes.
    Several: ``CONV_MMA_STAGES`` slots, each one chunk's weight rows (planes
    of chunk_c / x_bytes bytes a tap) and halo slice (``chunk_c`` bytes a
    pixel)."""
    cpc = _cpad_for(c)
    pixels = (block_h + fh - 1) * (block_w + fw - 1)
    if chunk_c is None or chunk_c == x_bytes * cpc:
        krow = fh * fw * w_bytes * cpc + 16
        return block_co * krow + CONV_MMA_STAGES * pixels * x_bytes * cpc
    krow = fh * fw * w_bytes * (chunk_c // x_bytes) + 16
    return CONV_MMA_STAGES * (block_co * krow + pixels * chunk_c)


def _int_conv_mma_geometry(n, out_h, out_w, c, fh, fw, co, x_bytes,
                           w_bytes, device_key) -> dict | None:
    """Launch geometry of the tensor-core K6 (csrc/int_conv2d_mma.cu), or
    None where no chunk fits (kernels of about 20 x 20 and more).  K5's
    512-pixel tiles and persistent blocks; ``block_co`` 16 (8 for Co <= 8);
    block_c = x_bytes * cpc staged bytes a halo pixel.  Where the resident
    weight block and the halo ring fit (block_co halved as needed) and no
    sum over all of K can reach 2^31 (fh * fw * c *
    ``INT_CONV_MMA_MAX_PROD`` < 2^31), one chunk (chunk_c = block_c), as
    :func:`_conv_mma_geometry`; else channel chunks of 32, 64 or a multiple
    of 128 channels (chunk_c = x_bytes * those), the largest whose ring
    fits and whose one-chunk sums stay in range, folded every
    :func:`conv_mma_fold_run` chunks."""
    prod = INT_CONV_MMA_MAX_PROD[(x_bytes, w_bytes)]
    taps = fh * fw
    bh, bw = _conv_mma_tile(out_w)
    top = INT_CONV_MMA_BLOCK_COS[0] if co <= INT_CONV_MMA_BLOCK_COS[0] \
        else INT_CONV_MMA_BLOCK_COS[-1]
    cos = [b for b in INT_CONV_MMA_BLOCK_COS if b <= top][::-1]
    cpc = _cpad_for(c)

    def smem(bco, chunk_ch):
        return int_conv_mma_smem_bytes(fh, fw, bh, bw, bco, c, x_bytes,
                                       w_bytes, x_bytes * chunk_ch)

    def plan(bco, chunk_ch):
        return dict(route="tensor_cores", block_h=bh, block_w=bw,
                    block_co=bco, block_c=x_bytes * cpc,
                    chunk_c=x_bytes * chunk_ch, chunks=-(-c // chunk_ch),
                    stages=CONV_MMA_STAGES, threads=CONV_MMA_THREADS,
                    blocks=_conv_mma_blocks(n, out_h, out_w, co, bh, bw,
                                            bco, device_key),
                    smem_bytes=smem(bco, chunk_ch))

    if taps * c * prod < 2**31:
        for b in cos:
            if smem(b, cpc) <= CONV_MMA_SMEM_MAX:
                return plan(b, cpc)
    for b in cos:
        for chunk in _chunk_sizes(cpc):
            if conv_mma_fold_run(taps, c, chunk, prod, -(-c // chunk)) >= 1 \
                    and smem(b, chunk) <= CONV_MMA_SMEM_MAX:
                return plan(b, chunk)
    return None


def int_conv2d_on_tensor_cores(x_shape: tuple, w_shape: tuple, *,
                               x_bytes: int, w_bytes: int,
                               padding: str = "VALID") -> bool:
    """Whether K6 runs on the int8 tensor cores for these shapes and
    operand widths: every shape whose ring of one 32-channel chunk fits the
    shared memory at 8 output channels (kernels up to about 19 x 19), at
    any C.  Wider kernels have no route (``plan_int_conv2d`` raises)."""
    n, h, w, c = x_shape
    fh, fw, _, co = w_shape
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    return _int_conv_mma_geometry(n, out_h, out_w, c, fh, fw, co, x_bytes,
                                  w_bytes, "cpu") is not None


def int_conv2d_core_geometry(x_shape: tuple, w_shape: tuple, *,
                             padding: str = "VALID", device="cpu") -> dict:
    """block_h, block_co, block_c, threads and smem_bytes of the CUDA-core
    conv tile (csrc/conv2d_tile.cuh) for K6 at these shapes, which takes
    any shape whose kernel fits its register window.  No plan routes
    there: the tile is kept as the comparison the tensor-core K6's rows
    are timed against."""
    n, h, w, c = x_shape
    fh, fw, _, co = w_shape
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    return _conv_geometry(n, out_h, out_w, c, fh, fw, co,
                          _device_key(device))


def plan_int_conv2d(x_shape: tuple, w_shape: tuple, *, x_bytes: int,
                    w_bytes: int, padding: str = "VALID",
                    backend: str = "auto", device="cpu") -> KernelPlan:
    """Plan an unpacked integer conv2d x [N, H, W, C] * w [Fh, Fw, C, Co]
    of ``x_bytes`` / ``w_bytes`` operands (1: int8, 2: int16) (K6, the
    paper's int16 baseline): the byte-plane implicit GEMM on the int8
    tensor cores (``route`` 'tensor_cores') with
    ``_int_conv_mma_geometry``, the weights resident where they fit, else
    channel chunks streamed through the ring.  Raises where no chunk fits
    the shared memory."""
    return _plan_int_conv2d(tuple(x_shape), tuple(w_shape), padding, x_bytes,
                            w_bytes, resolve_backend(backend, device),
                            _device_key(device))


@functools.lru_cache(maxsize=None)
def _plan_int_conv2d(x_shape, w_shape, padding, x_bytes, w_bytes, backend,
                     device_key) -> KernelPlan:
    if x_bytes not in (1, 2) or w_bytes not in (1, 2):
        raise TypeError(f"int_conv2d takes int8 or int16 operands (1 or 2 "
                        f"bytes), got {x_bytes} x {w_bytes} bytes")
    n, h, w, c = x_shape
    fh, fw, _, co = w_shape
    out_h, out_w = _conv_out(h, w, fh, fw, padding)
    geometry = _int_conv_mma_geometry(n, out_h, out_w, c, fh, fw, co,
                                      x_bytes, w_bytes, device_key)
    if geometry is None:
        raise ValueError(f"a {fh}x{fw} kernel does not fit the tensor-core "
                         f"K6's shared memory at 8 output channels and 32 "
                         f"channels a chunk")
    return KernelPlan(op="int_conv2d", backend=backend, x_bytes=x_bytes,
                      w_bytes=w_bytes, **geometry)


def clear_plan_cache():
    """Drop every memoized plan (a new tuning cache; tests)."""
    for fn in (_plan_packed_matmul, _plan_quantized_linear,
               _plan_quantize_pack, _plan_int_matmul, _plan_attention_decode,
               _plan_packed_conv2d, _plan_int_conv2d):
        fn.cache_clear()
