#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, on a machine with a Hopper card and the CUDA
toolkit:

    python3 chip_smoke.py

1. Builds every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one nvcc per source, in parallel) and prints the build time.
2. Kernel phase: at the full-width shapes of W2A2 ``stablelm-1.6b``
   serving, holds each kernel against its plain PyTorch version on the card
   (quantize-pack and the packed matmul bit-equal; attention within 1e-4
   with f32 queries and within 1e-4 + one bf16 ulp with the path's bf16
   queries, with a dead row exactly zero) and times the kernel, the plain
   version and one PyTorch call that computes the same function where
   there is one (CUDA-graph replay between CUDA events, median of repeats,
   inputs rotated over copies larger than the 50 MB L2 where the serving
   path reads them cold).
   ``bound_ms`` is the least time the card could take: the larger of the
   bytes moved over HBM bandwidth and the operations over the peak rate of
   the card's fastest unit for them (int8 tensor cores for the 2-bit
   lattice dot, bf16 tensor cores for attention's products).
   ``design_bound_ms`` takes the CUDA-core f32 rate these kernels run at.
3. Serve phase: full-width ``stablelm-1.6b`` W2A2 with random weights from a
   seed, through ``ServingEngine`` at kv_bits 16, 4 and 2, four greedy
   requests with staggered admission.  Fails unless every request finishes
   and every kernel was launched on that path with no plain-version call.
   At kv_bits 4 it profiles four decode passes (device kernel time, top
   kernels) and runs one prefill chunk and 8 decode steps with
   ``backend="torch"`` on the same weights, printing the logit difference.

The last line is ``{"ok": true, "device": {...}}``; any failure raises.
Without CUDA, or without the repository's ``src/repro_torch`` beside it, the
script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
L2_BYTES = 50 * 2**20
# Attention against its plain version: with f32 queries the two differ only
# in summation order (ATTN_TOL absolute and relative); with bf16 queries
# both round that f32 result to bf16, which adds at most one bf16 ulp
# (2^-7 of the value).
ATTN_TOL = 1e-4
ATTN_BF16_RTOL = 2.0 ** -7


def card_peaks(name: str) -> dict:
    """Peak rates of the card, dense, from NVIDIA's data sheets: HBM bytes/s,
    f32 op/s on the CUDA cores, bf16 and int8 op/s on the tensor cores.
    H100 SXM: 3.35 TB/s, 67 T, 989 T, 1,979 T; the PCIe part: 2.0 TB/s,
    51 T, 756 T, 1,513 T."""
    if "PCIe" in name:
        return {"hbm": 2.0e12, "f32": 51e12, "bf16": 756e12, "int8": 1513e12}
    return {"hbm": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound_ms(nbytes: float, ops: float, hbm: float, rate: float
             ) -> tuple[float, str]:
    """The larger of ``nbytes`` over the HBM rate and ``ops`` over ``rate``
    (the card's fastest unit for that work)."""
    t_bytes = nbytes / hbm * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, calls, reps=5) -> float:
    """Device time per call: ``calls`` (zero-argument launches) are captured
    once into a CUDA graph, which is replayed ``reps`` times between CUDA
    events; the median replay time over ``len(calls)``.  Replaying a graph
    leaves no host gaps between launches, so what is timed is the device
    work of each call, not Python's launch overhead."""
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
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def copies_for(nbytes: int) -> int:
    """Buffer copies to rotate so a pass reads twice the L2's size."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def kernel_phase(torch, peaks, dev):
    from repro_torch.core import packing
    from repro_torch.core.packing import PackSpec
    from repro_torch.kernels import quant_pack, ulppack_attention, \
        ulppack_matmul
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec = PackSpec(2, 2)
    rows = []

    # ---- K1 quantize_pack ------------------------------------------------
    scale = torch.tensor(1 / math.sqrt(3), dtype=torch.float32, device=dev)
    zp = torch.tensor(2, dtype=torch.int32, device=dev)
    for m, k in ((4, 2048), (64, 2048), (4, 5632)):
        x = torch.randn((m, k), generator=gen, device=dev) * 1.5
        lk, rk = quant_pack.quantize_pack_cuda(x, scale, zp, spec)
        lt, rt = quant_pack.quantize_pack_torch(x, scale, zp, spec)
        torch.cuda.synchronize()
        if not (torch.equal(lk, lt) and torch.equal(rk, rt)):
            raise AssertionError(f"quantize_pack [{m}, {k}] not bit-equal")
        kp = -(-k // spec.n_pack)
        nbytes = m * k * 4 + m * kp * spec.lane_bytes + m * 4 + 8
        # elementwise (divide, round, clip, shift): CUDA-core f32 work
        b, by = bound_ms(nbytes, 4 * m * k, peaks["hbm"], peaks["f32"])
        rows.append({
            "name": "quantize_pack", "shape": f"x[{m},{k}] {spec}",
            "max_abs_err": 0,
            "ms": time_ms(torch, [lambda: quant_pack.quantize_pack_cuda(
                x, scale, zp, spec)] * 20),
            "plain_ms": time_ms(torch, [lambda: quant_pack.quantize_pack_torch(
                x, scale, zp, spec)] * 5),
            "bound_ms": b, "bound_by": by, "library_ms": None})

    # ---- K2 ulppack_matmul -----------------------------------------------
    cases = [(spec, 4, 1024, 2048), (spec, 4, 1024, 5632),
             (spec, 4, 2816, 2048), (spec, 64, 1024, 5632),
             (PackSpec(2, 2, "int32", 2, 16), 4, 1024, 2048)]
    for sp, m, kp, n in cases:
        k = kp * sp.n_pack
        qa = torch.randint(0, 4, (m, k), generator=gen, device=dev,
                           dtype=torch.int32)
        qw = torch.randint(0, 4, (k, n), generator=gen, device=dev,
                           dtype=torch.int32)
        a = packing.pack_activations(qa, sp)
        w = packing.pack_weights(qw, sp)
        plan = ulppack_matmul.plan_lib.plan_packed_matmul(
            m, kp, n, sp, backend="cuda", device=dev)
        geo = dict(block_m=plan.block_m, block_k=plan.block_k,
                   splits=plan.splits)
        got = ulppack_matmul.ulppack_matmul_cuda(a, w, sp, **geo)
        want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ulppack_matmul {sp} {(m, kp, n)} not "
                                 f"bit-equal")
        ws = [w] + [w.clone() for _ in range(copies_for(w.numel() *
                                                        sp.lane_bytes) - 1)]
        # library yardstick on the unpacked lattices: torch._int_mm on int8
        # (it takes M > 16 only), else an f32 matmul, exact here (products
        # <= 9, sums < 2^24, TF32 off)
        if m > 16:
            lib_fn, lt = torch._int_mm, torch.int8
        else:
            lib_fn, lt = torch.matmul, torch.float32
        al = qa.to(lt)
        wls = [qw.to(lt) for _ in range(copies_for(qw.numel() *
                                                   al.element_size()))]
        if not torch.equal(lib_fn(al, wls[0]).to(torch.int32), got):
            raise AssertionError(f"{lib_fn.__name__} on the lattices "
                                 f"disagrees with the packed matmul")
        lib = time_ms(torch, [lambda wl=wl: lib_fn(al, wl) for wl in wls])
        del wls
        nbytes = (m * kp + kp * n) * sp.lane_bytes + m * n * 4
        # the card's floor: the 2-bit lattice MACs on the int8 tensor
        # cores; the design bound: this kernel's packed-lane MACs on the
        # CUDA cores at the f32 rate
        b, by = bound_ms(nbytes, 2 * m * k * n, peaks["hbm"], peaks["int8"])
        design = bound_ms(nbytes, 2 * m * kp * n, peaks["hbm"], peaks["f32"])
        rows.append({
            "name": "ulppack_matmul", "shape": f"({m},{kp},{n}) {sp}",
            "max_abs_err": 0, "design_bound_ms": design[0],
            "library": f"torch.{lib_fn.__name__} ({lt})",
            "ms": time_ms(torch, [lambda wi=wi: ulppack_matmul
                                  .ulppack_matmul_cuda(a, wi, sp, **geo)
                                  for wi in ws]),
            "plain_ms": time_ms(torch, [lambda: ulppack_matmul
                                        .ulppack_matmul_torch(a, w, sp)], 3),
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "geometry": geo})

    # ---- K3 attention_decode ---------------------------------------------
    bsz, s, h, kvh, hd = 4, 512, 32, 32, 64
    valid_len = torch.tensor([512, 300, 77, 0], dtype=torch.int32,
                             device=dev)
    for kv_bits in (16, 8, 4, 2):
        kf = torch.randn((bsz, s, kvh, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
        vf = torch.randn((bsz, s, kvh, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
        if kv_bits == 16:
            cache = {"k": kf, "v": vf}
            row_bytes = hd * 2
        else:
            qk, sk = attention.kv_quantize(kf, kv_bits)
            qv, sv = attention.kv_quantize(vf, kv_bits)
            cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
            row_bytes = qk.shape[-1] * qk.element_size() + 2
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        caches = [cache] + [{kk: t.clone() for kk, t in cache.items()}
                            for _ in range(copies_for(cache_bytes) - 1)]
        for c in (1, 16):
            q = torch.randn((bsz, c, h, hd), generator=gen,
                            device=dev).to(torch.bfloat16)
            qpos = (torch.clamp(valid_len, min=c)[:, None] - c
                    + torch.arange(c, device=dev)[None, :]).to(torch.int32)
            err = {}
            for qq in (q.float(), q):          # f32 queries, then the path's
                got = ulppack_attention.attention_decode_cuda(
                    qq, cache, valid_len, qpos, kv_bits=kv_bits, hd=hd)
                want = ulppack_attention.attention_decode_torch(
                    qq, cache, valid_len, qpos, kv_bits=kv_bits, hd=hd,
                    block_k=512).float()
                diff = (got.float() - want).abs()
                rtol = ATTN_TOL if qq.dtype == torch.float32 \
                    else ATTN_BF16_RTOL
                if not (torch.isfinite(got).all() and
                        (diff <= ATTN_TOL + rtol * want.abs()).all()):
                    raise AssertionError(
                        f"attention kv{kv_bits} C={c} {qq.dtype}: max abs err "
                        f"{float(diff.max())} beyond {ATTN_TOL} + {rtol}|want|")
                if got[3].any():
                    raise AssertionError("attention: dead row is not zero")
                err[qq.dtype] = float(diff.max())
            lib = None
            if kv_bits == 16:
                qs = q.transpose(1, 2).contiguous()
                ks, vs = (t.transpose(1, 2).contiguous() for t in (kf, vf))
                pos = torch.arange(s, device=dev)
                mask = ((pos[None, None, :] < valid_len[:, None, None])
                        & (pos[None, None, :] <= qpos[:, :, None]))[:, None]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib = time_ms(torch, [lambda: sdpa(qs, ks, vs,
                                                   attn_mask=mask)] * 10)
            # bytes: each live cache row once; operations: QK and PV over
            # the rows each query row really sees (causal within the window)
            live = torch.minimum(valid_len, qpos.max(dim=1).values + 1)
            live = int(live.clamp(min=0).sum())
            seen = torch.minimum(valid_len[:, None], qpos + 1)
            seen = int(seen.clamp(min=0).sum())
            nbytes = 2 * live * kvh * row_bytes + 2 * q.numel() * 2
            # the card's floor: QK and PV on the bf16 tensor cores (the
            # lattices, and q pre-scaled by hd^-0.5 = 1/8, are exact in
            # bf16); the design bound: this kernel's CUDA-core f32 MACs
            ops = 4 * h * hd * seen
            b, by = bound_ms(nbytes, ops, peaks["hbm"], peaks["bf16"])
            design = bound_ms(nbytes, ops, peaks["hbm"], peaks["f32"])
            rows.append({
                "name": "attention_decode",
                "shape": f"B{bsz} S{s} H{h} hd{hd} C{c} kv{kv_bits}",
                "max_abs_err": err[torch.bfloat16],
                "max_abs_err_f32_q": err[torch.float32],
                "design_bound_ms": design[0],
                "ms": time_ms(torch, [lambda cc=cc: ulppack_attention
                                      .attention_decode_cuda(
                                          q, cc, valid_len, qpos,
                                          kv_bits=kv_bits, hd=hd)
                                      for cc in caches]),
                "plain_ms": time_ms(torch, [lambda: ulppack_attention
                                            .attention_decode_torch(
                                                q, cache, valid_len, qpos,
                                                kv_bits=kv_bits, hd=hd,
                                                block_k=512)], 3),
                "bound_ms": b, "bound_by": by, "library_ms": lib})
    return rows


def serve_phase(torch, np, dev, cfg):
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine
    from repro_torch.serve.prepare import prepare_serving_params

    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} W{cfg.quant.w_bits}A"
          f"{cfg.quant.a_bits}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, random weights (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(max_batch=4, max_len=512, prefill_chunk=16)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (17, 33, 64, 100)]
    for kv_bits in (16, 4, 2):
        c = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(c, params, config=ecfg, device=dev)
        if kv_bits == 16:
            distinct = {tuple((k, v) for k, v in r.items() if k != "layer")
                        for r in eng.plan_report()}
            print(f"serve plans: {len(eng.plans)} layer plans, distinct: "
                  f"{[dict(d) for d in sorted(distinct, key=repr)]}")
        reqs = [Request(i, p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(3):                 # later admissions ride along
            eng.step()
        for r in reqs[2:]:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in reqs:
            if not (r.done and len(r.output) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.output)):
                raise AssertionError(f"kv{kv_bits}: request {r.uid} did not "
                                     f"finish with 32 in-range tokens")
        m = eng.metrics.report()
        cap = eng.capacity_report()
        rep = {"kv_bits": kv_bits, "wall_s": wall,
               "prefill_tok_s": m["prefill_tok_s"],
               "decode_tok_s": m["decode_tok_s"],
               "decode_step_ms": m["decode_step_ms"],
               "steps": m["steps"], "packed_param_bytes": cap["param_bytes"],
               "cache_bytes": cap["cache_bytes"],
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        print("serve " + json.dumps(rep))
        del eng
        torch.cuda.empty_cache()

    c = cfg.replace(quant=cfg.quant.replace(kv_bits=4))
    profile_decode(torch, c, params, ecfg, prompts, dev)
    # kernel path vs plain path on the same weights, kv_bits 4
    packed = prepare_serving_params(params, c, device=dev)
    return c, packed, prompts, steps, lm


def profile_decode(torch, cfg, params, ecfg, prompts, dev):
    """Where a decode step's time goes: four pure-decode passes at kv_bits 4
    under torch.profiler -- device kernel time per step (summed over CUDA
    kernels) against the profiled wall time, and the top kernels.  The
    profiler slows the host, so the idle share here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, config=ecfg, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=16))
    while eng.metrics.decode_passes == 0:
        eng.step()
    n = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    rep = {"kv_bits": cfg.quant.kv_bits, "decode_passes": n,
           "wall_ms_per_step": wall * 1e3 / n,
           "device_kernel_ms_per_step": busy_us / 1e3 / n,
           "idle_share_upper_bound": 1 - busy_us / 1e6 / wall,
           "kernel_launches_per_step": sum(e.count for e in kernels) / n,
           "top_kernels_ms_per_step": [
               [e.key[:60], e.self_device_time_total / 1e3 / n, e.count // n]
               for e in top]}
    print("profile " + json.dumps(rep))
    del eng
    torch.cuda.empty_cache()


def compare_backends(torch, np, dev, c, packed, prompts, steps, lm):
    width = 16
    tokens = np.stack([p[:width] for p in prompts])
    b = tokens.shape[0]
    caches = {be: lm.init_caches(c, b, 512, device=dev)
              for be in ("auto", "torch")}
    pre = {be: steps.make_prefill_chunk_step(c, backend=be)
           for be in caches}
    dec = {be: steps.make_decode_step(c, backend=be) for be in caches}
    index = np.zeros(b, np.int32)
    valid = np.full(b, width, np.int32)
    out = {be: pre[be](packed, caches[be], {"tokens": tokens}, index,
                       valid)[0].float() for be in caches}
    diffs, agree = [], []
    for i in range(9):
        diffs.append(float((out["auto"] - out["torch"]).abs().max()))
        nxt = out["auto"].argmax(dim=-1)
        agree.append(bool(torch.equal(nxt, out["torch"].argmax(dim=-1))))
        if not torch.isfinite(out["auto"]).all():
            raise AssertionError("non-finite logits on the kernel path")
        if i == 8:
            break
        tok = nxt.cpu().numpy().astype(np.int32)[:, None]
        ix = np.full(b, width + i, np.int32)
        one = np.ones(b, np.int32)
        out = {be: dec[be](packed, caches[be], {"tokens": tok}, ix,
                           one)[0].float() for be in caches}
    rep = {"kv_bits": 4, "steps": "1 prefill chunk + 8 decode",
           "max_logit_diff": max(diffs), "per_step_max_logit_diff": diffs,
           "greedy_agree_per_step": agree}
    print("kernel-vs-plain " + json.dumps(rep))
    return rep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.kernels import build, quant_pack, ulppack_attention, \
        ulppack_matmul

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {name} capability "
          f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    paths = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(paths)} libraries, nvcc in parallel)")
    for n, p in paths.items():
        log = (p.parent / f"{n}.log").read_text().splitlines()
        usage = [ln.strip() for ln in log if "registers" in ln
                 or "spill" in ln]
        print(f"ptxas {n}: " + " | ".join(usage[:6]))

    dev = torch.device("cuda")
    rows = kernel_phase(torch, peaks, dev)
    for r in rows:
        print("kernel " + json.dumps(r))

    mods = {"quantize_pack": quant_pack, "ulppack_matmul": ulppack_matmul,
            "attention_decode": ulppack_attention}
    for mod in mods.values():
        mod.reset_counts()
    from repro_torch import configs
    ctx = serve_phase(torch, np, dev, configs.get_config("stablelm-1.6b"))
    launches = {k: m.kernel_launches for k, m in mods.items()}
    plain = {k: m.plain_calls for k, m in mods.items()}
    print(f"serve launches (kv_bits 16, 4, 2 runs and the profiled kv_bits 4 "
          f"passes): kernels {launches}, plain {plain}")
    for k in mods:
        if launches[k] == 0 or plain[k] != 0:
            raise AssertionError(f"{k}: {launches[k]} kernel launches, "
                                 f"{plain[k]} plain calls on the serve path")
    compare_backends(torch, np, dev, *ctx)

    meta = {
        "quantize_pack": ("src/repro_torch/csrc/quant_pack.cu",
                          "src/repro/kernels/quant_pack.py:86",
                          "x[4,2048]"),
        "ulppack_matmul": ("src/repro_torch/csrc/ulppack_matmul.cu",
                           "src/repro/kernels/ulppack_matmul.py:99",
                           "(4,1024,2048) W2A2/int16xP2s8"),
        "attention_decode": ("src/repro_torch/csrc/attention_decode.cu",
                             "src/repro/kernels/ulppack_attention.py:395",
                             "B4 S512 H32 hd64 C1 kv4"),
    }
    summary = []
    for k, (source, replaces, shape) in meta.items():
        r = next(r for r in rows if r["name"] == k and
                 r["shape"].startswith(shape))
        summary.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
