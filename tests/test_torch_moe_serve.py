"""Serving a sliding-window MoE decoder (reduced ``mixtral-8x7b``, W2A2)
through the port's engine against the reference engine run op by op:
greedy tokens equal at kv 16 and 4 with the engine's static steps and
with the op-by-op steps, the serving prep (3-D experts and the router kept
float, plans only for the packed 2-D leaves, their bytes counted), the
ring's slot bytes, the prefill chunk clamped to 1, and the bridge carrying
the expert leaves.  The card's counterpart (graphed engine = eager) is in
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


def _cfgs(kv_bits, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=kv_bits)
    jc = jconfigs.get_config("mixtral-8x7b", reduced=True)
    tc = tconfigs.get_config("mixtral-8x7b", reduced=True)
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
def _reference(kv_bits, dtype, compiled=False):
    """The reference engine's greedy tokens, op by op (or, ``compiled``,
    with its jitted steps)."""
    jcfg, _ = _cfgs(kv_bits, dtype)
    jp, _ = _params(jcfg)
    ecfg = jengine.EngineConfig(max_batch=3, max_len=MAX_LEN,
                                prefill_chunk=CHUNK)
    if compiled:
        return _serve(jengine, jcfg, jp, ecfg)
    with jax.disable_jit():
        return _serve(jengine, jcfg, jp, ecfg)


@pytest.mark.parametrize("kv_bits,dtype", [(16, "float32"),
                                           (4, "bfloat16")])
@pytest.mark.parametrize("eager_steps", [False, True])
def test_engine_greedy_tokens_equal_reference(kv_bits, dtype, eager_steps):
    """Staggered admissions over 3 slots, prompts past the ring of 8
    slots, token-by-token prefill with decode riders, ragged decode with
    capacity drops: the port's greedy tokens (its static steps, or the
    op-by-op steps) equal the reference engine's run op by op."""
    _, tcfg = _cfgs(kv_bits, dtype)
    _, tp = _params(_cfgs(kv_bits, dtype)[0])
    got = _serve(tengine, tcfg, tp, tengine.EngineConfig(
        max_batch=3, max_len=MAX_LEN, prefill_chunk=CHUNK),
        eager_steps=eager_steps, device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference(kv_bits, dtype)


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
    jcfg, tcfg = _cfgs(4, "bfloat16")
    jp, tp = _params(jcfg)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    moe = tpk["layers"][0]["moe"]
    for name in ("up", "gate", "down"):
        assert set(moe[name]) == {"kernel", "w_step", "a_step"}
        assert moe[name]["kernel"] is tp["layers"][0]["moe"][name]["kernel"]
    assert set(moe["router"]) == {"kernel"}
    assert "w_packed" in tpk["layers"][0]["attn"]["q"]
    want = sum(np.asarray(x).nbytes for x in jax.tree.leaves(
        jax.device_get(jpk)) if hasattr(x, "nbytes"))
    assert tprepare.serving_param_bytes(tpk) == want
    expert_bytes = sum(moe[n]["kernel"].numel() * 2
                       for n in ("up", "gate", "down"))
    assert tprepare.serving_param_bytes(tpk) > expert_bytes * tcfg.num_layers
    jplans = jprepare.build_layer_plans(jpk, jcfg, batch_rows=3,
                                        prefill_rows=3)
    tplans = tprepare.build_layer_plans(tpk, tcfg, batch_rows=3,
                                        prefill_rows=3)
    assert sorted(tplans) == sorted(jplans)
    assert all("/attn/" in k for k in tplans) and len(tplans) == 8


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

