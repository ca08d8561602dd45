"""Dry run of every (architecture x input-shape x mesh) cell on the
reference's production meshes (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step on 512 forced host
devices and reads XLA's memory and cost analyses.  The port has no
partitioner, and its kernels are ctypes calls that do not trace, so its
dry run places and does not lower: it builds the step's arguments as
shape-only stand-ins on the ``meta`` device (the train state, or the
params -- packed for decode -- plus caches plus batch), gives every leaf
its spec by ``parallel/sharding``'s rules over the device-free
``make_production_mesh``, and sums one device's shard bytes.  The report
keeps the reference's keys where the port has the quantity; ``hlo_*`` and
``collective_s``, which need a compiled step, are absent, and ``reason``
says so.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k [--multi-pod] [--kv-bits N] [--out FILE]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``--all`` sweeps every cell of one mesh in this process and writes one
JSON file a cell under ``reports/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel import sharding
from repro_torch.roofline import analysis, hw
from repro_torch.serve import prepare

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

NOT_LOWERED = ("placed, not lowered: the port has no partitioner and its "
               "kernels do not trace, so no compiled step gives hlo_* "
               "FLOPs and bytes or the collectives behind collective_s")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def shard_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree``'s tensors placed by ``specs`` (a tree
    of the same structure, a spec tuple at each tensor) over ``mesh``."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(shard_bytes(v, sp, mesh) for v, sp in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    n = 1
    for d in sharding.shard_shape(tuple(tree.shape), specs, mesh):
        n *= d
    return n * tree.element_size()


def cell_arguments(cfg, shape_name: str, mesh) -> dict:
    """The step's arguments as ``meta`` stand-ins and their specs, by
    part: {part: (tree, specs)} for 'params', 'opt_state' (the optimizer
    moments and the step counter), 'caches' and 'batch' (with the decode
    index)."""
    shape = shp.SHAPES[shape_name]
    gb = shape.global_batch
    params = lm.init_params(cfg, device="meta")
    if shape.kind == "train":
        state = steps_lib.make_train_state(params, cfg=cfg)
        batch = shp.input_specs(cfg, shape_name)
        p_sh = sharding.param_shardings(state["params"], cfg, mesh)
        return {"params": (state["params"], p_sh),
                "opt_state": ((state["opt_state"], state["step"]),
                              (sharding.opt_state_shardings(
                                  state["opt_state"], p_sh, cfg, mesh), ())),
                "batch": (batch, sharding.batch_shardings(batch, cfg, mesh,
                                                          gb))}
    if shape.kind == "prefill":
        batch = shp.input_specs(cfg, shape_name)
        return {"params": (params, sharding.param_shardings(params, cfg,
                                                            mesh)),
                "batch": (batch, sharding.batch_shardings(batch, cfg, mesh,
                                                          gb))}
    packed = prepare.prepare_serving_params(params, cfg, device="meta")
    specs = shp.input_specs(cfg, shape_name)
    caches, batch = specs["caches"], specs["batch"]
    return {"params": (packed, sharding.param_shardings(packed, cfg, mesh)),
            "caches": (caches, sharding.cache_shardings(
                caches, cfg, mesh, gb,
                sequence_parallel=(shape_name == "long_500k"))),
            "batch": ((batch, specs["index"]),
                      (sharding.batch_shardings(batch, cfg, mesh, gb), ()))}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               kv_bits: int = -1, card: str = "") -> dict:
    """One cell's report: SKIP where ``cell_is_live`` says so, else the
    per-device argument bytes of the placed step, whether they fit one
    card's HBM, and the compute and memory terms over ``card``'s
    constants (``hw.card_constants``; SXM for an empty name)."""
    t0 = time.time()
    live, reason = shp.cell_is_live(arch, shape_name)
    if not live:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "status": "SKIP",
                "reason": reason}
    cfg = configs.get_config(arch)
    if kv_bits >= 0:
        cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    shape = shp.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    c = hw.card_constants(card)
    parts = cell_arguments(cfg, shape_name, mesh)
    mem = {part: shard_bytes(tree, specs, mesh)
           for part, (tree, specs) in parts.items()}
    arg_bytes = sum(mem.values())
    mflops = analysis.model_flops(cfg, shape)
    terms = {"compute_s": mflops / chips / c["bf16"],
             "memory_s": arg_bytes / c["hbm"]}
    counts = cfg.param_counts()
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "chips": chips, "status": "PLACED", **terms,
        "dominant": analysis.dominant_term(terms),
        "model_flops": mflops,
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            **{f"{k}_bytes": v for k, v in mem.items()}},
        "fits_hbm": arg_bytes <= c["hbm_bytes"],
        "card": c["variant"], "hbm_bytes_per_card": c["hbm_bytes"],
        "param_count_total": counts["total"],
        "param_count_active": counts["active"],
        "place_s": round(time.time() - t0, 2), "reason": NOT_LOWERED,
    }


def _report(arch, shape, multi_pod, kv_bits) -> dict:
    try:
        return lower_cell(arch, shape, multi_pod, kv_bits=kv_bits)
    except Exception as e:  # structured failure for the sweep report
        return {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
                "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def run_single(args) -> int:
    report = _report(args.arch, args.shape, args.multi_pod, args.kv_bits)
    out = json.dumps(report, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(out)
    print(out)
    return 0 if report["status"] in ("PLACED", "SKIP") else 1


def run_all(args) -> int:
    out_dir = Path(args.out) if args.out else REPORT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    failed = []
    for arch in configs.ARCH_NAMES:
        for shape in shp.SHAPES:
            r = _report(arch, shape, args.multi_pod, args.kv_bits)
            tag = f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}"
            (out_dir / f"{tag}.json").write_text(
                json.dumps(r, indent=1, default=str))
            mem = r.get("memory_analysis", {}).get("argument_size_in_bytes")
            print(f"[{r['status']}] {tag} bytes/device={mem} "
                  f"fits={r.get('fits_hbm')} dominant={r.get('dominant')}")
            if r["status"] == "FAIL":
                failed.append((tag, r["error"]))
    for tag, err in failed:
        print(f"  FAILED {tag}: {err[:200]}")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=-1,
                    help="override cfg.quant.kv_bits")
    ap.add_argument("--out", help="a cell's JSON file (a directory with "
                                  "--all)")
    args = ap.parse_args(argv)
    if args.all:
        return run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    return run_single(args)


if __name__ == "__main__":
    sys.exit(main())
