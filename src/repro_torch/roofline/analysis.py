"""Roofline terms over the H100's constants (counterpart of
``repro/roofline/analysis.py``).

  compute    = FLOPs (per device) / peak bf16 op/s
  memory     = bytes (per device) / HBM bytes/s
  collective = collective operand bytes (per device) / link bytes/s

:func:`collective_bytes` reads the collectives of a compiled XLA HLO text,
as the reference does; the port's own collectives are the shard joins of
``parallel/sharding.py`` (``join``, an all-gather, and ``add_up``, an
all-reduce, both in the ``shard_join`` profiler range), which
:func:`join_bytes` counts into the same keys.  :func:`bound_ms` is the
least time the card could take for a kernel's work.
"""

from __future__ import annotations

import contextlib
import re

from repro_torch.parallel import sharding
from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# operand type tokens like  bf16[16,4096]{1,0}  inside a collective call
_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


_OP_RE = re.compile(
    r"=\s+((?:\(?[\w\[\]{},\s]+?\)?))\s+("
    + "|".join(_COLLECTIVES) + r")(-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _empty() -> dict:
    out = {k: 0 for k in _COLLECTIVES}
    out["counts"] = {k: 0 for k in _COLLECTIVES}
    return out


def collective_bytes(hlo_text: str) -> dict:
    """Sum *operand* bytes per collective kind from compiled (post-SPMD) HLO.

    Compiled HLO prints operands by name only, so we read the RESULT type and
    convert to operand bytes per kind: all-reduce / all-to-all / permute have
    operand == result; all-gather operand = result / group; reduce-scatter
    operand = result * group (group size parsed from replica_groups=[n,g]).
    """
    out = _empty()
    count = out["counts"]
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if "-done(" in stripped:
            continue  # -start carries the shapes; -done would double count
        m = _OP_RE.search(stripped)
        if not m:
            continue
        result_types, kind = m.group(1), m.group(2)
        nbytes = sum(_shape_bytes(d, s)
                     for d, s in _TYPE_RE.findall(result_types))
        if nbytes == 0:
            continue
        gm = _GROUPS_RE.search(stripped)
        group = int(gm.group(2)) if gm else 1
        if kind == "all-gather":
            nbytes = nbytes // max(group, 1)
        elif kind == "reduce-scatter":
            nbytes = nbytes * max(group, 1)
        if kind == "all-gather" and "-start(" in stripped:
            # result of -start is a (operand, result) tuple: halve the
            # overcount from summing both tuple components
            nbytes = nbytes // 2
        out[kind] += nbytes
        count[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@contextlib.contextmanager
def join_bytes():
    """Count the shard joins run inside the block, into
    :func:`collective_bytes`'s keys (filled in when the block ends): a
    ``sharding.join`` of n parts is an all-gather whose per-device operand
    is one part (the parts' bytes / n), a ``sharding.add_up`` of n partial
    sums an all-reduce whose operand is one partial sum.  A join of one
    shard moves nothing and is not counted.  Joins replayed inside a CUDA
    graph run no Python, so count an eager pass."""
    out = _empty()
    sharding.JOIN_COUNTERS.append(out)
    try:
        yield out
    finally:
        sharding.JOIN_COUNTERS.remove(out)
        out["total"] = sum(out[k] for k in _COLLECTIVES)


def roofline_terms(cost: dict, coll_bytes: int, chips: int) -> dict:
    flops = float(cost.get("flops", 0.0) or 0.0)
    nbytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    return {
        "compute_s": flops / hw.PEAK_FLOPS_BF16,
        "memory_s": nbytes / hw.HBM_BW,
        "collective_s": coll_bytes / hw.LINK_BW,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "collective_bytes_per_device": coll_bytes,
        "chips": chips,
    }


def dominant_term(terms: dict) -> str:
    """The largest of the terms ``terms`` holds (``collective_s`` may be
    absent, as in the dry run's reports)."""
    vals = {k[:-2]: terms[k] for k in ("compute_s", "memory_s",
                                       "collective_s") if k in terms}
    return max(vals, key=vals.get)


def bound_ms(nbytes: float, ops: float, hbm: float, rate: float
             ) -> tuple[float, str]:
    """The least time the card could take for a kernel's work: the larger
    of ``nbytes`` over the HBM rate and ``ops`` over ``rate`` (the card's
    fastest unit for that work, :func:`hw.card_peaks`), in ms, and which of
    the two it is ('bytes' or 'operations')."""
    t_bytes = nbytes / hbm * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (useful-work accounting)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*tokens for serving, plus the
    attention term (full S^2 for dense, S*window for SWA, linear for
    SSM/xLSTM whose compute is inside N)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    s, gb = shape.seq_len, shape.global_batch
    hd = cfg.resolved_head_dim
    nq = cfg.num_heads
    attn_layers = sum(1 for i in range(cfg.num_layers)
                      if cfg.layer_kind(i) == "attn")
    attn_layers += cfg.encoder_layers

    if shape.kind == "train":
        tokens = gb * s
        kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
        attn = 3 * (4.0 * gb * nq * s * kv * hd) * attn_layers
        return 6.0 * n_active * tokens + attn
    if shape.kind == "prefill":
        tokens = gb * s
        kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
        attn = (4.0 * gb * nq * s * kv * hd) * attn_layers
        return 2.0 * n_active * tokens + attn
    # decode: one token against a seq_len cache
    kv = min(s, cfg.sliding_window) if cfg.sliding_window else s
    attn = (4.0 * gb * nq * 1 * kv * hd) * attn_layers
    return 2.0 * n_active * gb + attn


def summarize_cell(arch, shape_name, mesh_name, chips, cost, coll,
                   mflops) -> dict:
    terms = roofline_terms(cost, coll["total"], chips)
    dom = dominant_term(terms)
    hlo_global = terms["hlo_flops_per_device"] * chips
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips,
        **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        "dominant": dom,
        "hlo_flops_per_device": terms["hlo_flops_per_device"],
        "hlo_bytes_per_device": terms["hlo_bytes_per_device"],
        "collective_bytes_per_device": terms["collective_bytes_per_device"],
        "collective_counts": coll.get("counts", {}),
        "model_flops": mflops,
        "useful_ratio": (mflops / hlo_global) if hlo_global else float("nan"),
    }
