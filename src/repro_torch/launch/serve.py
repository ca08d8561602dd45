"""CLI server: pack a model for deployment and serve synthetic requests
through the continuous-batching engine (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --reduced --requests 3 --device cpu

On the card (``--device cuda``, the default) the full configs serve
through the hand-written kernels, each engine step a CUDA graph:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --max-batch 4 --max-len 512 --kv-bits 4 --requests 4 --autotune \\
        --metrics

``--autotune`` warm-tunes every serving signature the port's tuning cache
lacks before the plans are built and the graphs captured, then saves the
cache ($REPRO_TORCH_AUTOTUNE_CACHE, else
reports/autotune_torch_<device>.json); a later launch without the flag
plans from it (``source: tuned`` in the plan report).

The flags, their groups, choices and defaults are the reference's, plus
``--device``; the engine side is derived through the one
``EngineConfig.from_args`` call.  The parameters are random, drawn by
``lm.init_params`` from a ``torch.Generator`` seeded 0 on the device: the
reference's JAX draws cannot be reproduced without JAX, so the two CLIs
serve different weights.

``--model-parallel M`` serves one engine tensor-parallel over M devices
(serve/shard.ShardPlan: packed weights split by columns, the KV cache by
kv heads); ``--data-parallel N`` serves N replicas behind the
serve/router.Router, each M-way tensor-parallel.  Both build their mesh
with ``launch/mesh.make_serving_mesh`` over the host's distinct devices,
clamping (with a warning) to what the host has, and the summary names the
real shard and replica counts:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --max-batch 4 --max-len 512 --kv-bits 4 --model-parallel 2

``main(argv, mesh=ServingMesh([[cuda:0, cuda:0]]))`` lists the devices
explicitly instead, one repeated to place two shards on one card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import autotune as autotune_lib
from repro_torch.kernels import plan as plan_lib
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import lm
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Request, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    """The serving CLI surface (exposed so tests can parse flag lists and
    hold ``EngineConfig.from_args`` against the reference's)."""
    ap = argparse.ArgumentParser(
        description="Serve synthetic requests through the packed "
                    "continuous-batching engine.")
    ap.add_argument("--arch", required=True, choices=configs.ALL_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="print the full metrics report (throughput split "
                         "by phase, occupancy, per-request TTFT and "
                         "time-per-output-token mean/p50/p95) plus the "
                         "capacity report, the plan report and the tuning "
                         "cache's counts as JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (the hand-written kernels) or "
                         "on the CPU (their plain versions)")

    eng = ap.add_argument_group(
        "engine", "EngineConfig fields (serve/config.py) -- consumed by "
                  "EngineConfig.from_args, the single construction path")
    eng.add_argument("--max-batch", type=int, default=2)
    eng.add_argument("--max-len", type=int, default=64)
    eng.add_argument("--prefill-chunk", type=int, default=16)
    eng.add_argument("--max-queue", type=int, default=0,
                     help="backpressure cap on queued requests (0 = none)")
    eng.add_argument("--no-packed", action="store_true")
    eng.add_argument("--autotune", action="store_true",
                     help="warm-tune the serving kernel signatures missing "
                          "from the autotune cache before planning, then "
                          "persist the cache (tune once offline; plans "
                          "come back cache-backed on later launches)")
    eng.add_argument("--hbm-cache-budget-mb", type=float, default=0,
                     help="size batch slots from this cache budget (slots "
                          "= budget // cache bytes per slot; with "
                          "--paged-kv, pages = budget // page bytes) "
                          "instead of --max-batch (0 = no budget)")
    eng.add_argument("--paged-kv", action="store_true",
                     help="paged KV cache: block tables over a refcounted "
                          "page pool with prefix sharing and copy-on-write "
                          "(serve/pages.py); the budget then buys pages, "
                          "--max-batch bounds logical slots")
    eng.add_argument("--page-size", type=int, default=16,
                     help="token rows per KV page; a multiple of the "
                          "kv-bits word-packing tail (8 for 4-bit, 16 for "
                          "2-bit)")
    eng.add_argument("--no-prefix-sharing", action="store_true",
                     help="disable radix prefix sharing across paged "
                          "requests (pages still allocated on demand)")
    eng.add_argument("--speculative-k", type=int, default=0,
                     help="speculative decoding: draft up to K tokens per "
                          "decode pass with a sub-byte copy of the model, "
                          "verify them in one target call (0 = off)")
    eng.add_argument("--draft-w-bits", type=int, default=2,
                     choices=(1, 2, 3, 4),
                     help="draft model weight/activation precision (the "
                          "same checkpoint re-packed; only takes effect "
                          "on a packed engine)")
    eng.add_argument("--draft-kv-bits", type=int, default=-1,
                     choices=(-1, 0, 16, 8, 4, 2),
                     help="draft KV-cache precision override (-1 = "
                          "inherit the target's kv_bits)")

    samp = ap.add_argument_group("sampling")
    samp.add_argument("--temperature", type=float, default=0.0,
                      help="0 = greedy")
    samp.add_argument("--top-k", type=int, default=0)

    quant = ap.add_argument_group("quantization")
    quant.add_argument("--kv-bits", type=int, default=-1,
                       choices=(-1, 0, 16, 8, 4, 2),
                       help="KV cache storage precision override: 0/16 = "
                            "bf16, 8 = int8, 4/2 = bit-dense packed words; "
                            "-1 keeps the arch config's value")

    par = ap.add_argument_group("parallelism")
    par.add_argument("--model-parallel", type=int, default=1,
                     help="tensor-parallel shards per replica: packed "
                          "weights split by columns, the KV cache by kv "
                          "heads (serve/shard.ShardPlan); clamps to the "
                          "host's devices")

    fleet = ap.add_argument_group(
        "fleet", "replica fleet (serve/router.Router)")
    fleet.add_argument("--data-parallel", type=int, default=1,
                       help="replica count: serve over a ('data'=N, "
                            "'model'=M) mesh, one replica a data row, "
                            "behind one load-balanced router (least-loaded "
                            "placement, spillover, session affinity, "
                            "drain/restore)")
    return ap


def _fleet_main(args, cfg, params, econf: EngineConfig, mesh, dev):
    """Serve the synthetic requests through a Router over ``mesh``'s rows,
    alternating two sessions so that affinity shows in the report."""
    from repro_torch.serve.router import Router

    router = Router(cfg, params, config=econf, mesh=mesh, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        router.submit(
            rng.integers(0, cfg.vocab_size, args.prompt_len).astype(
                np.int32),
            max_new_tokens=args.max_new_tokens, session=f"session-{i % 2}")
    done = router.run_to_completion()
    rep = router.metrics_report()
    rep["capacity"] = router.capacity_report()
    toks = sum(len(h.output) for h in done)
    fleet = rep["fleet"]
    print(f"{len(done)} requests, {toks} generated tokens across "
          f"{fleet['attached']} replicas (mesh {mesh.shape})")
    if args.metrics:
        print(json.dumps(rep, indent=2))
    else:
        print(f"fleet prefill {fleet['prefill_tok_s']} tok/s, "
              f"decode {fleet['decode_tok_s']} tok/s, "
              f"ttft p95 {fleet['ttft_s']['p95']}s, "
              f"spilled {fleet['spilled']} "
              f"(--metrics for the full report)")
    return rep


def main(argv=None, *, mesh=None):
    """Run the CLI on ``argv``.  ``mesh`` (a launch/mesh.ServingMesh)
    replaces the one ``--model-parallel`` / ``--data-parallel`` build
    from the host's devices."""
    args = build_parser().parse_args(argv)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    lm.check_supported(cfg)
    if args.kv_bits >= 0:
        cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=args.kv_bits))
    dev = plan_lib.resolve_device(args.device)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    econf = EngineConfig.from_args(args)
    parallel = mesh is not None or args.model_parallel > 1 \
        or args.data_parallel > 1
    if mesh is None and parallel:
        mesh = make_serving_mesh(model=args.model_parallel,
                                 data=args.data_parallel, device=dev)
    if args.data_parallel > 1 or (mesh is not None
                                  and mesh.shape["data"] > 1):
        rep = _fleet_main(args, cfg, params, econf, mesh, dev)
        if args.autotune:
            print(f"autotune cache saved to "
                  f"{autotune_lib.active_cache().save()}")
        return rep

    before = len(autotune_lib.active_cache().entries)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, config=econf, device=dev, mesh=mesh)
    init_s = time.perf_counter() - t0
    tuned = len(autotune_lib.active_cache().entries) - before
    if args.autotune:
        print(f"autotune cache saved to "
              f"{autotune_lib.active_cache().save()}")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(
                np.int32),
            max_new_tokens=args.max_new_tokens))
    done = eng.run_to_completion()
    rep = eng.metrics.report()
    rep["capacity"] = eng.capacity_report()
    toks = sum(len(r.output) for r in done)
    # the shard count the engine really has: the mesh may have clamped
    shards = eng.shard_plan.model_shards if eng.shard_plan else 1
    print(f"{len(done)} requests, {toks} generated tokens"
          + (f" (model-parallel x{shards})" if parallel else ""))
    if args.metrics:
        rep["plans"] = eng.plan_report()
        rep["engine_init_s"] = init_s
        rep["autotune"] = {"cache": autotune_lib.active_cache().path,
                           "entries": len(autotune_lib.active_cache()
                                          .entries),
                           "tuned": tuned}
        print(json.dumps(rep, indent=2))
    else:
        print(f"prefill {rep['prefill_tok_s']} tok/s, "
              f"decode {rep['decode_tok_s']} tok/s, "
              f"ttft p50 {rep['ttft_s']['p50']}s, "
              f"tpot p50 {rep['tpot_s']['p50']}s "
              f"(--metrics for the full report)")
    return rep


if __name__ == "__main__":
    main()
