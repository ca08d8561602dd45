"""Serve a quantized LM with batched requests through the continuous-batching
engine; counterpart of ``examples/serve_quantized.py``.  Params are packed
offline into ULPPACK lanes (the paper's deployed path), the decode steps
run the packed integer kernels -- on the card the hand-written tensor-core
K2 with K1 folded in, K3 and the window write, replayed as CUDA graphs --
and the KV cache is stored sub-byte (kv_bits=4: bit-dense packed words +
per-(pos, head) scales), so a fixed cache budget admits ~4x the concurrent
sequences of bf16.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_quantized \\
          [--device cuda|cpu]

Tensor-parallel variant: ``--model-parallel N`` serves N shards (packed
weights column-parallel, KV cache sharded over the kv-head axis,
token-for-token identical output).  With fewer than N devices the N
shards share the one device (``ServingMesh([[dev] * N])``), so the split
still runs.

Replica fleet: ``--data-parallel N`` serves N replicas behind one
load-balanced front door (serve/router.Router), each ``--model-parallel``
shards wide on its own device group; without enough devices the fleet
falls back to process-local replicas sharing the device, and says so.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import plan as plan_lib
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import lm
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.prepare import prepare_serving_params, \
    serving_param_bytes


def host_devices(dev) -> int:
    """Distinct devices of ``dev``'s kind: the cards, or the one CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def serve_fleet(cfg, params, econf, data, model, dev):
    """Route a request burst through a replica fleet (Router front door)."""
    from repro_torch.serve.router import Router

    n_dev = host_devices(dev)
    if n_dev >= data * model:
        mesh = make_serving_mesh(model=model, data=data, device=dev)
        router = Router(cfg, params, config=econf, mesh=mesh, device=dev)
        print(f"fleet: {data} replicas x {model}-way TP on mesh "
              f"{mesh.shape} ({n_dev} host devices)")
    else:
        router = Router(cfg, params, config=econf, replicas=data,
                        device=dev)
        print(f"fleet: host has {n_dev} devices (< {data * model}); "
              f"falling back to {data} process-local replicas sharing "
              f"the host")
    rng = np.random.default_rng(0)
    handles = [router.submit(
        rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
        max_new_tokens=8, session=f"user-{i % 2}") for i in range(4)]
    t0 = time.time()
    router.run_to_completion()
    dt = time.time() - t0
    fleet = router.metrics_report()["fleet"]
    tokens = sum(len(h.output) for h in handles)
    print(f"served {len(handles)} requests, {tokens} tokens in {dt:.1f}s "
          f"(fleet decode {fleet['decode_tok_s']} tok/s = sum over "
          f"{fleet['attached']} replicas; spilled {fleet['spilled']})")
    for h in handles:
        print(f"  req {h.uid} -> replica {h.replica}: "
              f"{list(h.request.prompt)} -> {h.output}")
    return [h.output for h in handles]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel shards (on one device when the "
                         "host has fewer)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="replica count: >1 serves through the fleet "
                         "Router (least-loaded placement, session "
                         "affinity, spillover)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = plan_lib.resolve_device(args.device)

    cfg = configs.get_config("stablelm-1.6b", reduced=True).replace(
        d_model=128, num_heads=8, num_kv_heads=8, d_ff=384, num_layers=4,
        vocab_size=2048, param_dtype="float32", compute_dtype="float32",
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2, kv_bits=4))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    econf = EngineConfig(max_batch=2, max_len=64, packed=True)

    raw_bytes = serving_param_bytes(params)
    packed = prepare_serving_params(params, cfg, device=dev)
    packed_bytes = serving_param_bytes(packed)
    print(f"serving params: {raw_bytes/1e6:.1f} MB float -> "
          f"{packed_bytes/1e6:.1f} MB packed "
          f"({raw_bytes/packed_bytes:.1f}x smaller)")
    del packed

    if args.data_parallel > 1:
        return serve_fleet(cfg, params, econf, args.data_parallel,
                           args.model_parallel, dev)

    mesh = None
    if args.model_parallel > 1:
        n = args.model_parallel
        if host_devices(dev) >= n:
            mesh = make_serving_mesh(n, device=dev)
        else:
            mesh = ServingMesh([[dev] * n])
        print(f"serving mesh: {mesh.shape} over {host_devices(dev)} host "
              f"devices ({mesh})")

    eng = ServingEngine(cfg, params, config=econf, device=dev, mesh=mesh)
    cap = eng.capacity_report()
    if "shard_plan" in cap:
        print(f"shard plan: {cap['shard_plan']} — packed weights "
              f"column-parallel, kv cache head-sharded")
    bf16_slot = lm.cache_bytes(
        cfg.replace(quant=cfg.quant.replace(kv_bits=0)), 1, 64)
    print(f"kv cache: {cap['cache_bytes_per_slot']/1e3:.1f} KB/slot at "
          f"{cap['kv_bits']}-bit vs {bf16_slot/1e3:.1f} KB bf16 "
          f"({bf16_slot/cap['cache_bytes_per_slot']:.1f}x smaller)")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 6).astype(
                        np.int32),
                    max_new_tokens=8) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    done = eng.run_to_completion()
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens/dt:.1f} tok/s on {dev}, packed integer path)")
    for r in done:
        print(f"  req {r.uid}: prompt={list(r.prompt)} -> {r.output}")
    return [r.output for r in sorted(done, key=lambda r: r.uid)]


if __name__ == "__main__":
    main()
