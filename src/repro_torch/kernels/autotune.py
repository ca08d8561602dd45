"""Empirical KernelPlan autotuner with a persisted, schema-versioned cache
(counterpart of ``repro/kernels/autotune.py``).

The planners in kernels/plan.py pick launch geometry from cost models
fitted by hand on one H100; this module measures those choices instead,
over bounded candidate grids that plan.py enumerates (so geometry keeps one
owner), and keeps a candidate only when its first call gives the plain
version's result (bit-equal on the integer routes):

  * ``tune_quantized_linear`` -- the serving path's call: on the card the
    fused route (K1 folded into the tensor-core K2) for every layout,
    block_m x stages a split; the 'torch' backend delegates to
    ``tune_packed_matmul``
  * ``tune_packed_matmul``    -- K2's lattice dot, lanes or the dense store:
    block_m x stages a split on the tensor cores
  * ``tune_packed_conv2d``    -- K5: block_co x block_w on the tensor cores
    (each with the channel chunks the planner gives it)
  * ``tune_attention_decode`` -- K3 / K4: splits x tile_rows
  * ``tune_attention_chunk``  -- the q-chunk of ``chunked_attention``
  * ``tune_matmul_layout`` / ``tune_conv2d_layout`` -- the lane layout
    itself (``packing.layout_family``), each candidate tile-tuned by the
    tuners above and held bit-equal to kernels/ref.py's integer oracle

Layout choices are keyed WITHOUT the row count (weights pack once and serve
every batch size) and resolved by ``matmul_layout_for`` /
``conv2d_layout_for`` -- the one function packers, planners and dispatch
all call, so the layout the stored bytes use and the layout the kernel
expects cannot drift while one cache is active.

On the 'torch' backend the plain versions have no geometry: the tile
tuners measure the heuristic plan alone and store it with ``candidates:
1`` (so ``--autotune --device cpu`` works end to end and the plans come
back ``source='tuned'``); the layout sweep runs on both backends.

Winners persist to a JSON cache of the port's own: ``$REPRO_TORCH_AUTOTUNE_
CACHE`` if set, else ``reports/autotune_torch_<device>.json``, where
``<device>`` is ``cpu`` or the card's name normalised
(``nvidia-h100-80gb-hbm3``): tiles tuned on one card do not carry to
another.  The reference's ``REPRO_AUTOTUNE_CACHE`` / ``autotune_<device>.
json`` are its own.  A stale or corrupt file is ignored with a warning; the
planners consult the active cache first and fall back to their heuristics
on a miss.  Plans stay memoized, so writing to the active cache clears
them.

``measure_us`` is the one timing method of the tuner and of
``chip_smoke.py``'s kernel rows: on the card, device time by CUDA-graph
replay between CUDA events over calls whose operands rotate past the L2;
on the CPU, the median of repeats on the host clock.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.packing import PackSpec
from repro_torch.kernels import plan as plan_lib

# Schema 2, the reference's: PackSpec keys carry their shift suffix
# ("W2A2/int16xP2s8") and layout_* entries record the winning layout.
SCHEMA_VERSION = 2

#: Environment override for the file the active cache loads from.
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

#: The reference's candidate caps.
MATMUL_MAX_CANDIDATES = 16
CONV_MAX_CANDIDATES = 12
ATTN_CHUNKS = (32, 64, 128, 256, 512)
#: A K3 entry serves K4 too: its splits are whole pages of this many rows
#: (the engine's default page size) unless the caller names another.
ATTN_PAGE_ROWS = 16
#: Attention candidates must stay within this of the plain version (f32
#: queries: the two differ only in summation order).
ATTN_TOL = 1e-4

#: The H100's L2; ``copies_for`` rotates operands past it.
L2_BYTES = 50 * 2**20

_REPO_ROOT = Path(__file__).resolve().parents[3]


def device_kind() -> str:
    """The device axis of the cache's file name: 'cpu', or the first
    card's name, lower case, runs of other characters as one '-'."""
    if not torch.cuda.is_available():
        return "cpu"
    return re.sub(r"[^a-z0-9]+", "-",
                  torch.cuda.get_device_name(0).lower()).strip("-")


def default_cache_path(device: str | None = None) -> str:
    """$REPRO_TORCH_AUTOTUNE_CACHE if set, else
    reports/autotune_torch_<device>.json at the repo root."""
    env = os.environ.get(ENV_CACHE)
    if env:
        return env
    return str(_REPO_ROOT / "reports"
               / f"autotune_torch_{device or device_kind()}.json")


# ---------------------------------------------------------------------------
# Cache keys -- human-readable, deterministic strings
# ---------------------------------------------------------------------------

def matmul_key(m: int, kp: int, n: int, spec: PackSpec, *, backend: str,
               weight_store: str = "lanes") -> str:
    return (f"packed_matmul|{backend}|m={m}|kp={kp}|n={n}|spec={spec}"
            f"|store={weight_store}")


def quantized_linear_key(m: int, k: int, n: int, spec: PackSpec,
                         x_bytes: int, *, backend: str,
                         weight_store: str = "lanes") -> str:
    """The fused route's signature: the float activations' element size
    sets the ring, so it is part of the key."""
    return (f"quantized_linear|{backend}|m={m}|k={k}|n={n}|spec={spec}"
            f"|xb={x_bytes}|store={weight_store}")


def conv2d_key(x_shape: tuple, w_shape: tuple, spec: PackSpec, *,
               padding: str, backend: str,
               weight_store: str = "lanes") -> str:
    xs = "x".join(str(d) for d in x_shape)
    ws = "x".join(str(d) for d in w_shape)
    return (f"packed_conv2d|{backend}|x={xs}|w={ws}|pad={padding}"
            f"|spec={spec}|store={weight_store}")


def attention_key(b: int, sq: int, skv: int, h: int, kvh: int, hd: int,
                  kv_bits: int) -> str:
    return (f"attention_chunk|b={b}|sq={sq}|skv={skv}|h={h}|kvh={kvh}"
            f"|hd={hd}|kv_bits={kv_bits}")


def attention_decode_key(b: int, c: int, skv: int, h: int, kvh: int,
                         hd: int, kv_bits: int, *, backend: str) -> str:
    """K3's and K4's one signature: the logical shape, without the page
    size.  The reference keys its paged decode apart (``ps=``); here the
    split count sets the online softmax's rounding, and the paged engine's
    tokens equal the unpaged engine's only while K4 splits the rows as K3
    does -- so both adopt one entry, whose splits are whole pages."""
    return (f"attention_decode|{backend}|b={b}|c={c}|skv={skv}|h={h}"
            f"|kvh={kvh}|hd={hd}|kv_bits={kv_bits}")


def matmul_layout_key(k: int, n: int, w_bits: int, a_bits: int, *,
                      backend: str, weight_store: str = "lanes") -> str:
    """Lane-layout choice for a [*, k] x [k, n] weight, NOT keyed on the
    row count: weights pack once and serve every batch size."""
    return (f"layout_matmul|{backend}|k={k}|n={n}|w={w_bits}|a={a_bits}"
            f"|store={weight_store}")


def conv2d_layout_key(x_shape: tuple, w_shape: tuple, w_bits: int,
                      a_bits: int, *, padding: str, backend: str,
                      weight_store: str = "lanes") -> str:
    """Lane-layout choice for a conv2d; shapes are the UNPACKED x [N, H, W,
    Cin] and w [Fh, Fw, Cin, Co]."""
    xs = "x".join(str(d) for d in x_shape)
    ws = "x".join(str(d) for d in w_shape)
    return (f"layout_conv2d|{backend}|x={xs}|w={ws}|pad={padding}"
            f"|wb={w_bits}|ab={a_bits}|store={weight_store}")


# ---------------------------------------------------------------------------
# TuningCache: load / lookup / store / save
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuningCache:
    """One device's tuning results: {signature key: winner entry}."""

    device: str
    entries: dict = dataclasses.field(default_factory=dict)
    path: str | None = None

    def lookup(self, key: str) -> dict | None:
        return self.entries.get(key)

    def store(self, key: str, entry: dict) -> None:
        self.entries[key] = entry

    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "device": self.device,
                "entries": self.entries}

    def save(self, path: str | None = None) -> str:
        path = path or self.path or default_cache_path(self.device)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "TuningCache | None":
        """Parse a cache file; a corrupt or stale-schema file is ignored
        with a warning (the planners' heuristics remain)."""
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            warnings.warn(f"ignoring corrupt autotune cache {path}: {e}",
                          stacklevel=2)
            return None
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            warnings.warn(
                f"ignoring autotune cache {path}: schema "
                f"{raw.get('schema') if isinstance(raw, dict) else '?'} != "
                f"{SCHEMA_VERSION}", stacklevel=2)
            return None
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(f"ignoring autotune cache {path}: no entries dict",
                          stacklevel=2)
            return None
        return cls(device=raw.get("device", "unknown"), entries=entries,
                   path=path)


# ---------------------------------------------------------------------------
# Active cache (what the planners consult)
# ---------------------------------------------------------------------------

_UNSET = object()
_active: TuningCache | object = _UNSET


def _clear_memoized():
    plan_lib.clear_plan_cache()
    attention_chunk_for.cache_clear()


def active_cache() -> TuningCache:
    """The process-wide cache the planners consult, loaded lazily from
    ``default_cache_path()``; an empty cache when there is no file (every
    lookup misses: the heuristics)."""
    global _active
    if _active is _UNSET:
        dev = device_kind()
        _active = (TuningCache.load(default_cache_path(dev))
                   or TuningCache(device=dev))
    return _active


def set_active_cache(cache: TuningCache) -> TuningCache:
    """Install ``cache`` and drop every plan memoized under the last one."""
    global _active
    _active = cache
    _clear_memoized()
    return cache


def load_cache(path: str) -> TuningCache:
    """Load and activate ``path`` (an empty cache if it is unreadable)."""
    return set_active_cache(TuningCache.load(path)
                            or TuningCache(device=device_kind()))


def reset_active_cache() -> None:
    """Back to the lazy default (tests; a changed environment)."""
    global _active
    _active = _UNSET
    _clear_memoized()


def lookup(key: str) -> dict | None:
    """The planners' lookup against the active cache; never raises."""
    try:
        return active_cache().lookup(key)
    except Exception as e:  # a broken cache must never break planning
        warnings.warn(f"autotune lookup failed: {e}", stacklevel=2)
        return None


def _store(cache: TuningCache, key: str, entry: dict) -> None:
    """Store a result; a write to the ACTIVE cache drops every memoized
    plan, so later planner calls see it."""
    cache.store(key, entry)
    if cache is _active:
        _clear_memoized()


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def copies_for(nbytes: int) -> int:
    """Operand copies to rotate so a pass reads twice the L2's size."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def measure_us(calls, *, device="cpu", repeats: int = 5,
               min_time_s: float = 0.01, max_calls: int = 256) -> float:
    """Time per call in microseconds of ``calls`` (a zero-argument callable
    or a list of them, e.g. one per rotating operand copy).

    On a CUDA device: the calls are warmed up off the default stream,
    captured once into a CUDA graph and the graph replayed ``repeats``
    times between CUDA events; the median replay over ``len(calls)``.
    Replaying leaves no host gaps between launches, so what is timed is
    the device work, not Python's launch overhead.  On the CPU: the
    median of ``repeats`` batches on the host clock, each batch doubled
    until it takes ``min_time_s`` (at most ``max_calls`` calls)."""
    calls = list(calls) if isinstance(calls, (list, tuple)) else [calls]
    if torch.device(device).type == "cuda":
        return 1e3 * _graph_ms(calls, repeats)
    for c in calls:
        c()

    def batch(n: int) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            calls[i % len(calls)]()
        return time.perf_counter() - t0

    n = len(calls)
    dt = batch(n)
    while dt < min_time_s and n < max_calls:
        n = min(2 * n, max_calls)
        dt = batch(n)
    samples = [dt / n] + [batch(n) / n for _ in range(max(0, repeats - 1))]
    return float(statistics.median(samples) * 1e6)


def _graph_ms(calls, repeats: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream
        for c in calls[:2]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The candidate sweep
# ---------------------------------------------------------------------------

def _bound(cands: list, limit: int) -> list:
    """Deterministically subsample an over-long candidate list."""
    if len(cands) <= limit:
        return list(cands)
    step = len(cands) / limit
    return [cands[int(i * step)] for i in range(limit)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sweep(heur, cands: list, fields: tuple, call, copies: int, check, *,
           device, repeats: int, max_candidates: int,
           agree: str = "bit_equal") -> dict:
    """Measure ``heur`` and the candidate geometries (at most
    ``max_candidates``; the heuristic's always among them).  Each
    candidate's plan runs once through ``call(plan, 0)`` and
    ``check(out)`` -> (ok, err) decides whether it may win; then it is
    timed over ``call(plan, i)`` for each operand copy i < ``copies``.
    A launch that fails raises: the candidate passed the
    planner's own constraints.  Returns the entry: the winner's ``fields``,
    ``wall_us``, ``heuristic_us``, ``candidates``, ``agree`` (named
    ``bit_equal`` or ``within_tol``: every candidate passed ``check``) and
    ``max_err`` (the winner's)."""
    if heur.backend != "cuda":
        cands = []                        # the plain version has no geometry
    heur_geo = {f: getattr(heur, f) for f in fields}
    picked = _bound([c for c in cands
                     if {f: c[f] for f in fields} != heur_geo],
                    max(0, max_candidates - 1))
    best, heuristic_us, all_ok = None, None, True
    for geo in [None] + picked:
        plan = heur if geo is None else dataclasses.replace(
            heur, **geo, source="tuned")
        out = call(plan, 0)
        _sync(device)
        ok, err = check(out)
        if not ok:
            all_ok = False
            warnings.warn(f"autotune candidate {plan.describe()} disagrees "
                          f"with the plain version ({err}); excluded",
                          stacklevel=3)
            continue
        us = measure_us([functools.partial(call, plan, i)
                         for i in range(copies)], device=device,
                        repeats=repeats)
        if geo is None:
            heuristic_us = us
        if best is None or us < best[0]:
            best = (us, plan, err)
    if best is None:
        raise RuntimeError(f"no candidate of {heur.describe()} agrees with "
                           f"the plain version")
    us, plan, err = best
    entry = {f: getattr(plan, f) for f in fields}
    entry.update(
        wall_us=round(us, 3),
        heuristic_us=None if heuristic_us is None else round(heuristic_us, 3),
        candidates=1 + len(picked), max_err=err)
    entry[agree] = all_ok
    if plan.smem_bytes is not None:
        entry["smem_bytes"] = plan.smem_bytes
    return entry


def _exact(want):
    def check(out):
        return bool(torch.equal(out, want)), 0
    return check


def _resolve(backend: str, device):
    dev = plan_lib.resolve_device(device)
    return plan_lib.resolve_backend(backend, dev), dev


def _ints(rng, hi: int, shape, dev) -> torch.Tensor:
    return torch.as_tensor(rng.integers(0, hi + 1, shape), dtype=torch.int32,
                           device=dev)


def _lanes_or_words(q_w, spec: PackSpec, weight_store: str, axis: int):
    if weight_store == "dense":
        return packing.pack_words(q_w, spec.w_bits, axis=axis)
    return packing.pack_weights(q_w, spec, axis=axis)


def _copies(t: torch.Tensor) -> list:
    return [t] + [t.clone() for _ in range(
        copies_for(t.numel() * t.element_size()) - 1)]


# ---------------------------------------------------------------------------
# Tile tuners (measure candidates, store the winner)
# ---------------------------------------------------------------------------

_MMA_FIELDS = ("block_m", "block_k", "splits", "stages")


def tune_packed_matmul(m: int, kp: int, n: int, spec: PackSpec, *,
                       weight_store: str = "lanes",
                       k_full: int | None = None, backend: str = "auto",
                       device="cuda", cache: TuningCache | None = None,
                       max_candidates: int = MATMUL_MAX_CANDIDATES,
                       repeats: int = 5, force: bool = False,
                       seed: int = 0) -> dict:
    """Measure K2's lattice dot [m, kp] x W -> s32 over
    ``plan.packed_matmul_candidates`` and store the winner under
    ``matmul_key``: each candidate's first call bit-equal to the plain
    version, W rotated past the L2."""
    backend, dev = _resolve(backend, device)
    cache = cache if cache is not None else active_cache()
    key = matmul_key(m, kp, n, spec, backend=backend,
                     weight_store=weight_store)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    heur = plan_lib.plan_packed_matmul(
        m, kp, n, spec, weight_store=weight_store, k_full=k_full,
        backend=backend, device=dev, use_tuning_cache=False)
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    k = heur.k_full if heur.k_full is not None else kp * spec.n_pack
    q_a, q_w = _ints(rng, spec.max_a, (m, k), dev), \
        _ints(rng, spec.max_w, (k, n), dev)
    a = packing.pack_activations(q_a, spec, axis=-1)
    ws = _copies(_lanes_or_words(q_w, spec, weight_store, 0))
    want = ops.packed_matmul(a, ws[0], spec, backend="torch",
                             weight_store=weight_store, k_full=k_full)
    entry = _sweep(
        heur, plan_lib.packed_matmul_candidates(
            m, kp, n, spec, weight_store=weight_store, k_full=k_full,
            device=dev),
        _MMA_FIELDS,
        lambda p, i: ops.packed_matmul(a, ws[i], spec, plan=p), len(ws),
        _exact(want), device=dev, repeats=repeats,
        max_candidates=max_candidates)
    _store(cache, key, entry)
    return entry


def tune_quantized_linear(m: int, k: int, n: int, spec: PackSpec,
                          x_dtype=torch.bfloat16, *,
                          weight_store: str = "lanes",
                          backend: str = "auto", device="cuda",
                          cache: TuningCache | None = None,
                          max_candidates: int = MATMUL_MAX_CANDIDATES,
                          repeats: int = 5, force: bool = False,
                          seed: int = 0) -> dict:
    """Tune the serving path's call, ``ops.quantized_linear`` on x [m, k]
    of ``x_dtype``.  On the card that is the fused route for every layout
    (K1 folded into the tensor-core K2): block_m x stages a split, each
    candidate's first call bit-equal to the plain route's output, stored
    under ``quantized_linear_key``.  The 'torch' backend runs the packed
    matmul's plan, so there this is :func:`tune_packed_matmul` at ``kp =
    ceil(k / n_pack)``."""
    backend, dev = _resolve(backend, device)
    kp = -(-k // spec.n_pack)
    if backend != "cuda":
        return tune_packed_matmul(
            m, kp, n, spec, weight_store=weight_store,
            k_full=k if weight_store == "dense" else None, backend=backend,
            device=dev, cache=cache, max_candidates=max_candidates,
            repeats=repeats, force=force, seed=seed)
    cache = cache if cache is not None else active_cache()
    key = quantized_linear_key(m, k, n, spec, x_dtype.itemsize,
                               backend=backend, weight_store=weight_store)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    heur = plan_lib.plan_quantized_linear(
        m, k, n, spec, x_dtype, weight_store=weight_store, backend=backend,
        device=dev, use_tuning_cache=False)
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0.0, 1.5, (m, k)), dtype=torch.float32,
                        device=dev).to(x_dtype)
    q_w = _ints(rng, spec.max_w, (k, n), dev)
    ws = _copies(_lanes_or_words(q_w, spec, weight_store, 0))
    affine = (q_w.sum(dim=0, dtype=torch.int32),
              torch.tensor(3 ** -0.5, device=dev),     # stablelm's a_step
              torch.tensor((spec.max_a + 1) // 2, dtype=torch.int32,
                           device=dev),
              torch.tensor(0.02, device=dev),
              torch.tensor((spec.max_w + 1) // 2, dtype=torch.int32,
                           device=dev))

    def run(p, i, backend="cuda"):
        return ops.quantized_linear(x, ws[i], *affine, spec, plan=p,
                                    backend=backend,
                                    weight_store=weight_store,
                                    out_dtype=x_dtype)
    want = ops.quantized_linear(x, ws[0], *affine, spec, backend="torch",
                                weight_store=weight_store, out_dtype=x_dtype)
    entry = _sweep(
        heur, plan_lib.packed_matmul_candidates(
            m, kp, n, spec, weight_store=weight_store, x_dtype=x_dtype,
            k_full=k, device=dev),
        _MMA_FIELDS, run, len(ws), _exact(want), device=dev,
        repeats=repeats, max_candidates=max_candidates)
    _store(cache, key, entry)
    return entry


def tune_packed_conv2d(x_shape: tuple, w_shape: tuple, spec: PackSpec, *,
                       padding: str = "SAME", weight_store: str = "lanes",
                       k_full: int | None = None, backend: str = "auto",
                       device="cuda", cache: TuningCache | None = None,
                       max_candidates: int = CONV_MAX_CANDIDATES,
                       repeats: int = 5, force: bool = False,
                       seed: int = 0) -> dict:
    """Measure K5 over packed x [N, H, W, Cp] and w [Fh, Fw, Cdim, Co] on
    ``plan.packed_conv2d_candidates`` (block_co x block_w on the tensor
    cores) and store the winner under
    ``conv2d_key``; each candidate's first call bit-equal to the plain
    version."""
    backend, dev = _resolve(backend, device)
    cache = cache if cache is not None else active_cache()
    x_shape, w_shape = tuple(x_shape), tuple(w_shape)
    key = conv2d_key(x_shape, w_shape, spec, padding=padding,
                     backend=backend, weight_store=weight_store)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    heur = plan_lib.plan_packed_conv2d(
        x_shape, w_shape, spec, padding=padding, backend=backend,
        weight_store=weight_store, k_full=k_full, device=dev,
        use_tuning_cache=False)
    from repro_torch.kernels import ops

    nb, h, w, cp = x_shape
    fh, fw, _, co = w_shape
    cin = heur.k_full if heur.k_full is not None else cp * spec.n_pack
    rng = np.random.default_rng(seed)
    xp = packing.pack_activations(_ints(rng, spec.max_a, (nb, h, w, cin),
                                        dev), spec, axis=-1)
    wp = _lanes_or_words(_ints(rng, spec.max_w, (fh, fw, cin, co), dev),
                         spec, weight_store, 2)
    # the activations are the large operand: rotate both past the L2
    n_copies = copies_for(sum(t.numel() * t.element_size()
                              for t in (xp, wp)))
    xs = [xp] + [xp.clone() for _ in range(n_copies - 1)]
    ws = [wp] + [wp.clone() for _ in range(n_copies - 1)]
    want = ops.packed_conv2d(xp, wp, spec, padding=padding,
                             backend="torch", weight_store=weight_store,
                             k_full=k_full)
    entry = _sweep(
        heur, plan_lib.packed_conv2d_candidates(x_shape, w_shape, spec,
                                                padding=padding, device=dev),
        ("block_co", "block_w", "block_h"),
        lambda p, i: ops.packed_conv2d(xs[i], ws[i], spec, padding=padding,
                                       plan=p), n_copies,
        _exact(want), device=dev, repeats=repeats,
        max_candidates=max_candidates)
    _store(cache, key, entry)
    return entry


def tune_attention_decode(b: int, c: int, skv: int, h: int, kvh: int,
                          hd: int, *, kv_bits: int = 0,
                          backend: str = "auto", device="cuda",
                          cache: TuningCache | None = None,
                          max_candidates: int = MATMUL_MAX_CANDIDATES,
                          repeats: int = 5, force: bool = False,
                          seed: int = 0) -> dict:
    """Measure the flash-decoding read (K3) over
    ``plan.attention_decode_candidates`` -- splits x tile_rows, each split
    whole pages of ``ATTN_PAGE_ROWS``, so that K4 adopts the entry too --
    and store the winner under ``attention_decode_key``, shared by K3 and
    K4.  The workload is the decode step's: ``c`` f32 query rows a
    sequence against a ``skv``-row cache with 2/3 of the rows live; a
    candidate may win only within ``ATTN_TOL`` of the plain version (the
    split count changes the softmax's summation order)."""
    backend, dev = _resolve(backend, device)
    cache = cache if cache is not None else active_cache()
    key = attention_decode_key(b, c, skv, h, kvh, hd, kv_bits,
                               backend=backend)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    from repro_torch.kernels import ulppack_attention as ua
    from repro_torch.models import attention

    cache_dtype = torch.bfloat16 if kv_bits in (0, 16) else None
    heur = plan_lib.plan_attention_decode(
        b, c, skv, h, kvh, hd, kv_bits, cache_dtype=cache_dtype,
        backend=backend, device=dev, use_tuning_cache=False)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)
    kf, vf = (normal(b, skv, kvh, hd).to(torch.bfloat16) for _ in range(2))
    if kv_bits in (8, 4, 2):
        (qk, sk), (qv, sv) = (attention.kv_quantize(t, kv_bits)
                              for t in (kf, vf))
        kv = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        kv = {"k": kf, "v": vf}
    nbytes = sum(t.numel() * t.element_size() for t in kv.values())
    kvs = [kv] + [{name: t.clone() for name, t in kv.items()}
                  for _ in range(copies_for(nbytes) - 1)]
    q = normal(b, c, h, hd)
    live = max(c, (2 * skv) // 3)
    valid_len = torch.full((b,), live, dtype=torch.int32, device=dev)
    qpos = (live - c + torch.arange(c, device=dev, dtype=torch.int32)
            )[None, :].expand(b, c).contiguous()
    want = ua.attention_decode_torch(q, kv, valid_len, qpos, kv_bits=kv_bits,
                                     hd=hd, block_k=heur.block_k)

    def check(out):
        err = float((out.float() - want).abs().max())
        return bool(torch.isfinite(out).all() and torch.allclose(
            out.float(), want, rtol=ATTN_TOL, atol=ATTN_TOL)), err

    entry = _sweep(
        heur, plan_lib.attention_decode_candidates(
            b, c, skv, h, kvh, hd, kv_bits, align=ATTN_PAGE_ROWS,
            cache_dtype=cache_dtype),
        ("tile_rows", "split_rows", "splits"),
        lambda p, i: ua.fused_decode_attention(
            q, kvs[i], valid_len, qpos, kv_bits=kv_bits, hd=hd, plan=p),
        len(kvs), check, device=dev, repeats=repeats,
        max_candidates=max_candidates, agree="within_tol")
    _store(cache, key, entry)
    return entry


def tune_attention_chunk(b: int, sq: int, skv: int, h: int, kvh: int,
                         hd: int, *, kv_bits: int = 0, device="cuda",
                         dtype=torch.bfloat16,
                         cache: TuningCache | None = None,
                         repeats: int = 5, force: bool = False,
                         seed: int = 0) -> dict:
    """Measure the q-chunk of ``models.attention.chunked_attention`` (the
    prefill's causal attention over the window's raw K/V) for one
    (batch, q-len, kv-len, heads, head-dim, kv_bits) signature."""
    from repro_torch.models import attention

    dev = plan_lib.resolve_device(device)
    cache = cache if cache is not None else active_cache()
    key = attention_key(b, sq, skv, h, kvh, hd, kv_bits)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(dtype)
    q, k, v = normal(b, sq, h, hd), normal(b, skv, kvh, hd), \
        normal(b, skv, kvh, hd)
    pos = torch.arange(skv, device=dev)[None, :].expand(b, skv)
    q_pos = pos[:, :sq]

    def mask_fn(qpos):
        return pos[:, None, :] <= qpos[:, :, None]

    cands = [ch for ch in ATTN_CHUNKS if ch <= max(sq, ATTN_CHUNKS[0])]
    default = attention.Q_CHUNK
    if default not in cands:
        cands.append(default)
    best, heuristic_us = None, None
    with torch.no_grad():
        for chunk in cands:
            us = measure_us(lambda ch=chunk: attention.chunked_attention(
                q, k, v, mask_fn, q_pos, ch), device=dev, repeats=repeats)
            if chunk == default:
                heuristic_us = us
            if best is None or us < best[0]:
                best = (us, chunk)
    us, chunk = best
    entry = {"q_chunk": int(chunk), "wall_us": round(us, 3),
             "heuristic_us": round(heuristic_us, 3),
             "candidates": len(cands)}
    _store(cache, key, entry)
    return entry


@functools.lru_cache(maxsize=None)
def attention_chunk_for(b: int, sq: int, skv: int, h: int, kvh: int,
                        hd: int, kv_bits: int = 0) -> int:
    """The tuned q-chunk of a ``chunked_attention`` signature
    (``models.attention.Q_CHUNK`` on a miss)."""
    entry = lookup(attention_key(b, sq, skv, h, kvh, hd, kv_bits))
    if isinstance(entry, dict) and isinstance(entry.get("q_chunk"), int) \
            and entry["q_chunk"] >= 1:
        return entry["q_chunk"]
    from repro_torch.models.attention import Q_CHUNK
    return Q_CHUNK


# ---------------------------------------------------------------------------
# Lane-layout sweep: the PackSpec as a tuning axis
# ---------------------------------------------------------------------------

def _layout_entry(best, base_spec: PackSpec, base_us, tried: int,
                  family: int) -> dict:
    """The winning layout, its and the base layout's wall_us, and how many
    of the ``family``'s layouts were bit-equal (``bit_equal``: all)."""
    us, spec = best
    return {"spec": str(spec), "wall_us": round(us, 3),
            "base_spec": str(base_spec),
            "base_us": None if base_us is None else round(base_us, 3),
            "candidates": tried, "bit_equal": tried == family}


def tune_matmul_layout(m: int, k: int, n: int, base_spec: PackSpec, *,
                       x_dtype=torch.bfloat16, weight_store: str = "lanes",
                       backend: str = "auto", device="cuda",
                       cache: TuningCache | None = None,
                       max_candidates: int = MATMUL_MAX_CANDIDATES,
                       repeats: int = 5, force: bool = False,
                       seed: int = 0) -> dict:
    """Sweep ``packing.layout_family`` for a [k, n] weight at ``m`` rows.

    Each layout is tile-tuned by :func:`tune_quantized_linear` (the
    serving path's call, so the winner also lands with tuned tiles) and
    its lattice dot, through the tuned plan, must be bit-equal to
    ``ref.matmul_i32_ref`` before it may win: a layout that ever
    mismatched would corrupt every layer packed under it.  The winner is
    stored under :func:`matmul_layout_key` -- (k, n), not m -- and
    resolved by :func:`matmul_layout_for`."""
    from repro_torch.kernels import ops, ref

    backend, dev = _resolve(backend, device)
    cache = cache if cache is not None else active_cache()
    key = matmul_layout_key(k, n, base_spec.w_bits, base_spec.a_bits,
                            backend=backend, weight_store=weight_store)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    rng = np.random.default_rng(seed)
    q_a = _ints(rng, base_spec.max_a, (m, k), dev)
    q_w = _ints(rng, base_spec.max_w, (k, n), dev)
    want = ref.matmul_i32_ref(q_a, q_w)
    k_full = k if weight_store == "dense" else None
    best, base_us, tried = None, None, 0
    family = packing.layout_family(base_spec.w_bits, base_spec.a_bits,
                                   base_spec)
    for spec in family:
        entry = tune_quantized_linear(
            m, k, n, spec, x_dtype, weight_store=weight_store,
            backend=backend, device=dev, cache=cache,
            max_candidates=max_candidates, repeats=repeats, force=force,
            seed=seed)
        got = ops.packed_matmul(
            packing.pack_activations(q_a, spec, axis=-1),
            _lanes_or_words(q_w, spec, weight_store, 0), spec,
            backend=backend, weight_store=weight_store, k_full=k_full)
        _sync(dev)
        if not torch.equal(got, want):
            warnings.warn(f"layout candidate {spec} failed bit-exactness at "
                          f"m={m} k={k} n={n}; excluded", stacklevel=2)
            continue
        tried += 1
        us = float(entry["wall_us"])
        if spec == base_spec:
            base_us = us
        if best is None or us < best[0]:
            best = (us, spec)
    entry = _layout_entry(best, base_spec, base_us, tried, len(family))
    _store(cache, key, entry)
    return entry


def tune_conv2d_layout(x_shape: tuple, w_shape: tuple, base_spec: PackSpec,
                       *, padding: str = "SAME", weight_store: str = "lanes",
                       backend: str = "auto", device="cuda",
                       cache: TuningCache | None = None,
                       max_candidates: int = CONV_MAX_CANDIDATES,
                       repeats: int = 5, force: bool = False,
                       seed: int = 0) -> dict:
    """Layout sweep for one conv2d; ``x_shape`` / ``w_shape`` are the
    UNPACKED x [N, H, W, Cin] and w [Fh, Fw, Cin, Co].  Each layout is
    tile-tuned by :func:`tune_packed_conv2d` and held bit-equal to
    ``ref.conv2d_i32_ref`` (see :func:`tune_matmul_layout`)."""
    from repro_torch.kernels import ops, ref

    backend, dev = _resolve(backend, device)
    cache = cache if cache is not None else active_cache()
    nb, h, w, cin = x_shape
    fh, fw, _, co = w_shape
    key = conv2d_layout_key(tuple(x_shape), tuple(w_shape),
                            base_spec.w_bits, base_spec.a_bits,
                            padding=padding, backend=backend,
                            weight_store=weight_store)
    if not force and cache.lookup(key) is not None:
        return cache.lookup(key)
    rng = np.random.default_rng(seed)
    q_x = _ints(rng, base_spec.max_a, (nb, h, w, cin), dev)
    q_w = _ints(rng, base_spec.max_w, (fh, fw, cin, co), dev)
    want = ref.conv2d_i32_ref(q_x, q_w, padding=padding)
    best, base_us, tried = None, None, 0
    family = packing.layout_family(base_spec.w_bits, base_spec.a_bits,
                                   base_spec)
    for spec in family:
        cp = -(-cin // spec.n_pack)
        if weight_store == "dense":
            cdim, k_full = plan_lib.dense_words(cin, spec.w_bits), cin
        else:
            cdim, k_full = cp, None
        entry = tune_packed_conv2d(
            (nb, h, w, cp), (fh, fw, cdim, co), spec, padding=padding,
            weight_store=weight_store, k_full=k_full, backend=backend,
            device=dev, cache=cache, max_candidates=max_candidates,
            repeats=repeats, force=force, seed=seed)
        got = ops.packed_conv2d(
            packing.pack_activations(q_x, spec, axis=-1),
            _lanes_or_words(q_w, spec, weight_store, 2), spec,
            padding=padding, backend=backend, weight_store=weight_store,
            k_full=k_full)
        _sync(dev)
        if not torch.equal(got, want):
            warnings.warn(f"layout candidate {spec} failed bit-exactness at "
                          f"x={x_shape} w={w_shape}; excluded", stacklevel=2)
            continue
        tried += 1
        us = float(entry["wall_us"])
        if spec == base_spec:
            base_us = us
        if best is None or us < best[0]:
            best = (us, spec)
    entry = _layout_entry(best, base_spec, base_us, tried, len(family))
    _store(cache, key, entry)
    return entry


def _layout_from_entry(entry, w_bits: int, a_bits: int) -> PackSpec | None:
    """Decode and check a layout entry; None on any mismatch (the caller
    then keeps the config's spec)."""
    if not isinstance(entry, dict) or not isinstance(entry.get("spec"), str):
        return None
    try:
        spec = PackSpec.parse(entry["spec"])
    except ValueError:
        return None
    if spec.w_bits != w_bits or spec.a_bits != a_bits or not spec.feasible:
        return None
    return spec


def matmul_layout_for(k: int, n: int, base_spec: PackSpec, *,
                      backend: str = "auto", device="cpu",
                      weight_store: str = "lanes") -> PackSpec:
    """The chosen lane layout of a [*, k] x [k, n] weight on ``device``.

    Packers (serve/prepare, models/common), planners and dispatch
    (dense_apply) all resolve through here against the active cache, with
    the config's ``base_spec`` on a miss -- an empty cache keeps every
    layer in the base layout."""
    backend = plan_lib.resolve_backend(backend, device)
    entry = lookup(matmul_layout_key(k, n, base_spec.w_bits,
                                     base_spec.a_bits, backend=backend,
                                     weight_store=weight_store))
    return _layout_from_entry(entry, base_spec.w_bits,
                              base_spec.a_bits) or base_spec


def conv2d_layout_for(x_shape: tuple, w_shape: tuple, base_spec: PackSpec,
                      *, padding: str = "SAME", backend: str = "auto",
                      device="cpu", weight_store: str = "lanes") -> PackSpec:
    """The chosen lane layout of a conv2d (unpacked shapes; see
    :func:`matmul_layout_for`)."""
    backend = plan_lib.resolve_backend(backend, device)
    entry = lookup(conv2d_layout_key(tuple(x_shape), tuple(w_shape),
                                     base_spec.w_bits, base_spec.a_bits,
                                     padding=padding, backend=backend,
                                     weight_store=weight_store))
    return _layout_from_entry(entry, base_spec.w_bits,
                              base_spec.a_bits) or base_spec
