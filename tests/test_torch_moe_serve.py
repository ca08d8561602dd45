"""Serving a sliding-window MoE decoder (reduced ``mixtral-8x7b`` and
``mixtral-8x22b``, W2A2) through the port's engine against the reference
engine run op by op: greedy tokens equal at kv 16 and 4 with the engine's
static steps and with the op-by-op steps, the serving prep (3-D experts
kept float as their LSQ lattices, bit-equal to the reference's
per-forward ``_expert_kernel``, without ``w_step``; the router f32; plans
only for the packed 2-D leaves; their bytes counted), a 'packed' forward
over the prepared experts bit-equal to one over the float experts
(mixtral and jamba), the ring's slot bytes, the prefill chunk clamped to
1, and the bridge carrying the expert leaves.  The card's counterpart (graphed engine = eager) is in
``tests/test_torch_cuda_graphs.py``, which does not import JAX.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs, tree  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

MAX_LEN, CHUNK = 32, 8
PROMPTS = (5, 11, 17, 9)           # 11 and 17 wrap the ring of 8 slots
NEW = 6


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(kv_bits, dtype, name="mixtral-8x7b"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=kv_bits)
    jc = jconfigs.get_config(name, reduced=True)
    tc = tconfigs.get_config(name, reduced=True)
    return jc.replace(quant=JQ(**q), **kw), tc.replace(quant=TQ(**q), **kw)


def _params(jcfg, seed=1):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_repro(jax.device_get(jp), device="cpu")


def _serve(module, cfg, params, ecfg, eager_steps=False, **kw):
    eng = module.ServingEngine(cfg, params, config=ecfg, **kw)
    if eager_steps:                  # the op-by-op steps of launch/steps.py
        run_cfg = eng.cfg
        eng._decode = tsteps.make_decode_step(run_cfg)
        eng._prefill = tsteps.make_prefill_chunk_step(run_cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    reqs = [module.Request(i, p, max_new_tokens=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.submit(r)
    for _ in range(3):                 # later admissions ride mid-stream
        eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference(kv_bits, dtype, compiled=False, name="mixtral-8x7b"):
    """The reference engine's greedy tokens, op by op (or, ``compiled``,
    with its jitted steps)."""
    jcfg, _ = _cfgs(kv_bits, dtype, name)
    jp, _ = _params(jcfg)
    ecfg = jengine.EngineConfig(max_batch=3, max_len=MAX_LEN,
                                prefill_chunk=CHUNK)
    if compiled:
        return _serve(jengine, jcfg, jp, ecfg)
    with jax.disable_jit():
        return _serve(jengine, jcfg, jp, ecfg)


#: (config, kv_bits, dtype, eager_steps) of the engine-token cases; the
#: mixtral-8x7b cases keep their ids, mixtral-8x22b's are prefixed
ENGINE_CASES = [
    pytest.param(name, kv_bits, dtype, eager,
                 id=f"{prefix}{eager}-{kv_bits}-{dtype}")
    for name, prefix in (("mixtral-8x7b", ""), ("mixtral-8x22b", "8x22b-"))
    for eager in (False, True)
    for kv_bits, dtype in ((16, "float32"), (4, "bfloat16"))]


@pytest.mark.parametrize("name,kv_bits,dtype,eager_steps", ENGINE_CASES)
def test_engine_greedy_tokens_equal_reference(name, kv_bits, dtype,
                                              eager_steps):
    """Staggered admissions over 3 slots, prompts past the ring of 8
    slots, token-by-token prefill with decode riders, ragged decode with
    capacity drops: the port's greedy tokens (its static steps, or the
    op-by-op steps) over its prepared experts equal the reference engine's
    run op by op, which fake-quantizes them on every forward."""
    jcfg, tcfg = _cfgs(kv_bits, dtype, name)
    _, tp = _params(jcfg)
    got = _serve(tengine, tcfg, tp, tengine.EngineConfig(
        max_batch=3, max_len=MAX_LEN, prefill_chunk=CHUNK),
        eager_steps=eager_steps, device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference(kv_bits, dtype, name=name)


def _first_divergence(a, b):
    return next((i for i in range(len(a)) if a[i] != b[i]), len(a))


def test_engine_vs_compiled_reference():
    """Against the reference's jitted steps (bf16, kv 4): XLA fuses and
    rounds differently from the ops as written, and a one-ulp change can
    flip a 2-bit lattice, so each request's first divergence from the
    compiled reference is reported with the compiled reference's top-2
    logit margin there; the port agrees with it at least as long as the
    reference's own op-by-op run does."""
    from repro.models import lm as jlm_
    jcfg, tcfg = _cfgs(4, "bfloat16")
    jp, tp = _params(jcfg)
    want = _reference(4, "bfloat16", compiled=True)
    eager = _reference(4, "bfloat16")
    got = _serve(tengine, tcfg, tp, tengine.EngineConfig(
        max_batch=3, max_len=MAX_LEN, prefill_chunk=CHUNK), device="cpu")
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    for uid, (w, g, e) in enumerate(zip(want, got, eager)):
        i = _first_divergence(w, g)
        if i < len(w):
            seq = np.concatenate([prompts[uid], np.asarray(w[:i], np.int32)])
            logits = jax.jit(lambda p, t: jlm_.forward(
                p, jcfg, {"tokens": t}, quant_mode="packed")[0])(
                jpk, seq[None])[0, -1]
            top = np.sort(np.asarray(logits, np.float32))[-2:]
            print(f"request {uid}: first divergence from the compiled "
                  f"reference at token {i} (reference {w[i]}, port {g[i]}), "
                  f"reference top-2 margin {float(top[1] - top[0]):.4g}")
        assert i >= _first_divergence(w, e), (uid, w, g, e)


def test_serving_prep_keeps_experts_float():
    """The prep keeps the 3-D experts float, not packed: each kernel
    becomes its LSQ lattice in the compute dtype, bit-equal to the
    reference's per-forward ``_expert_kernel(..., 'packed')`` on the same
    weights (f32 and bf16 compute), ``w_step`` dropped and ``a_step``
    kept; the router stays f32; the plans are the reference's; the bytes
    are the reference's prepared tree's but the dropped 4-byte steps."""
    from repro.models import moe as jmoe
    for kv_bits, dtype in ((16, "float32"), (4, "bfloat16")):
        jcfg, tcfg = _cfgs(kv_bits, dtype)
        jp, tp = _params(jcfg)
        jpk = jprepare.prepare_serving_params(jp, jcfg)
        tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
        for i in range(tcfg.num_layers):
            moe = tpk["layers"][i]["moe"]
            for name in ("up", "gate", "down"):
                assert set(moe[name]) == {"kernel", "a_step"}
                got = moe[name]["kernel"]
                want = np.asarray(jmoe._expert_kernel(
                    jp["layers"][i]["moe"], name, jcfg, "packed"))
                assert got.dtype == getattr(torch, dtype)
                assert got.shape == want.shape
                assert got.view(torch.uint8 if dtype == "bfloat16"
                                else torch.int32).numpy().tobytes() \
                    == want.tobytes(), (i, name, dtype)
                assert moe[name]["a_step"] is \
                    tp["layers"][i]["moe"][name]["a_step"]
            assert set(moe["router"]) == {"kernel"}
            assert moe["router"]["kernel"].dtype == torch.float32
        assert "w_packed" in tpk["layers"][0]["attn"]["q"]
        want = sum(np.asarray(x).nbytes for x in jax.tree.leaves(
            jax.device_get(jpk)) if hasattr(x, "nbytes"))
        steps = 3 * 4 * tcfg.num_layers          # every layer is MoE
        assert tprepare.serving_param_bytes(tpk) == want - steps
        jplans = jprepare.build_layer_plans(jpk, jcfg, batch_rows=3,
                                            prefill_rows=3)
        tplans = tprepare.build_layer_plans(tpk, tcfg, batch_rows=3,
                                            prefill_rows=3)
        assert sorted(tplans) == sorted(jplans)
        assert all("/attn/" in k for k in tplans) and len(tplans) == 8
        # a prepared tree passes through the prep again unchanged
        again = tprepare.prepare_serving_params(tpk, tcfg, device="cpu")
        assert again["layers"][1]["moe"]["down"]["kernel"] is \
            tpk["layers"][1]["moe"]["down"]["kernel"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_forward_over_prepared_experts_equals_float_experts(arch,
                                                                   dtype):
    """A 'packed' forward over the prepared tree (the lattices derived
    once) gives logits bit-equal to the same forward over that tree with
    its float experts and steps put back (fake-quantized on every
    forward): prefill, then a cached decode step."""
    from repro_torch.models import lm as tlm

    _, cfg = _cfgs(4, dtype, arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    prepared = tprepare.prepare_serving_params(params, cfg, device="cpu")
    floats = [dict(layer, moe=params["layers"][i]["moe"])
              if "moe" in layer else layer
              for i, layer in enumerate(prepared["layers"])]
    floats = dict(prepared, layers=floats)
    n_moe = sum("moe" in layer for layer in prepared["layers"])
    assert n_moe and all("w_step" in layer["moe"]["up"]
                         for layer in floats["layers"] if "moe" in layer)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    out = {}
    for label, tree_ in (("prepared", prepared), ("float", floats)):
        caches = tlm.init_caches(cfg, 2, 16, dtype=torch.bfloat16,
                                 device="cpu")
        first, _, caches = tlm.forward(tree_, cfg, {"tokens": tokens},
                                       quant_mode="packed", caches=caches)
        nxt = first[:, -1].float().argmax(-1).numpy().astype(np.int32)
        second, _, _ = tlm.forward(
            tree_, cfg, {"tokens": nxt[:, None]}, quant_mode="packed",
            caches=caches, cache_index=np.full(2, 7, np.int32),
            cache_valid=np.ones(2, np.int32))
        out[label] = (first, second)
    for a, b in zip(out["prepared"], out["float"]):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


def test_bridge_carries_expert_leaves():
    jcfg, _ = _cfgs(4, "bfloat16")
    jp, tp = _params(jcfg)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    got = tree.flatten_with_path(tp)
    assert len(got) == len(want)
    back = jax.tree.leaves(bridge.to_repro(tp))
    for (_, w), b in zip(want, back):
        assert np.asarray(w).dtype == np.asarray(b).dtype
        assert np.asarray(w).tobytes() == np.asarray(b).tobytes()
    leaf = tp["layers"][1]["moe"]["down"]
    assert leaf["kernel"].dim() == 3 and leaf["kernel"].dtype == torch.bfloat16
    assert leaf["w_step"].dtype == torch.float32


def test_engine_capacity_and_chunk_follow_the_ring():
    jcfg, tcfg = _cfgs(4, "bfloat16")
    jp, tp = _params(jcfg)
    budget = 5 * tprepare.cache_bytes_per_slot(tcfg, MAX_LEN)
    kw = dict(max_batch=8, max_len=MAX_LEN, prefill_chunk=CHUNK,
              hbm_cache_budget=budget)
    eng = tengine.ServingEngine(tcfg, tp, config=tengine.EngineConfig(**kw),
                                device="cpu")
    ref = jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(**kw))
    assert eng.prefill_chunk == ref.prefill_chunk == 1
    assert eng.cache_bytes_per_slot == ref.cache_bytes_per_slot
    assert eng.max_batch == ref.max_batch == 5
    assert eng.caches[0]["attn"]["k"].shape[1] == tcfg.sliding_window
    rep = eng.capacity_report()
    assert rep["cache_bytes"] == 5 * eng.cache_bytes_per_slot
    with pytest.raises(ValueError, match="sliding-window"):
        tengine.ServingEngine(tcfg, tp, config=tengine.EngineConfig(
            paged=True, max_len=MAX_LEN), device="cpu")

