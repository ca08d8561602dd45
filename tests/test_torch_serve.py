"""The port's serving slice against the JAX reference at reduced size
(``stablelm-1.6b --reduced``, W2A2): the parameter bridge, packed forward
logits, in-place cache stepping, engine-level greedy token identity, the
device rule, and the no-JAX import rule."""

import ast
import functools
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAX_LEN, CHUNK = 48, 8


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture(autouse=True)
def base_layouts():
    """Pin the reference's per-layer lane layout to the config's base spec
    (an empty tuning cache), the only layout the port serves."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _cfgs(kv_bits, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jc = jconfigs.get_config("stablelm-1.6b", reduced=True)
    tc = tconfigs.get_config("stablelm-1.6b", reduced=True)
    return (jc.replace(quant=JQ(enabled=True, w_bits=2, a_bits=2,
                                kv_bits=kv_bits), **kw),
            tc.replace(quant=TQ(enabled=True, w_bits=2, a_bits=2,
                                kv_bits=kv_bits), **kw))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_repro(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trip_keeps_bf16_bits():
    jcfg, _ = _cfgs(0, dtype="bfloat16")
    jp, tp = _params(jcfg)
    assert tp["embed"]["table"].dtype == torch.bfloat16
    back = bridge.to_numpy(tp)
    want = jax.tree.leaves(jax.device_get(jp))
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.astype(np.float32))
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    bits = tp["layers"][0]["attn"]["q"]["kernel"].view(torch.int16).numpy()
    assert bits.tobytes() == np.asarray(
        jp["layers"][0]["attn"]["q"]["kernel"]).tobytes()


# ---------------------------------------------------------------------------
# Forward and steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 4, 2])
def test_packed_forward_logits_match(kv_bits):
    """A ragged prefill-chunk window then one decode step through the packed
    forward, from the same weights: logits within 1e-3 (f32 compute; the
    lattices are equal, rope/norm/softmax may differ in the last bits)."""
    jcfg, tcfg = _cfgs(kv_bits)
    jp, tp = _params(jcfg, seed=kv_bits)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    rng = np.random.default_rng(kv_bits)
    b = 3
    tokens = rng.integers(0, tcfg.vocab_size, (b, CHUNK)).astype(np.int32)
    index = np.array([0, 5, 0], np.int32)
    valid = np.array([CHUNK, 3, 0], np.int32)
    jcache = jlm.init_caches(jcfg, b, MAX_LEN)
    tcache = tlm.init_caches(tcfg, b, MAX_LEN, device="cpu")
    dec_tok = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    index2 = index + valid
    valid2 = np.array([1, 1, 0], np.int32)
    with jax.disable_jit():            # the reference op by op, as below
        jl, jcache = jsteps.make_prefill_chunk_step(jcfg)(
            jpk, jcache, {"tokens": jnp.asarray(tokens)}, jnp.asarray(index),
            jnp.asarray(valid))
        jl2, _ = jsteps.make_decode_step(jcfg)(
            jpk, jcache, {"tokens": jnp.asarray(dec_tok)},
            jnp.asarray(index2), jnp.asarray(valid2))
        # a cache-free forward over the same tokens reads the same attention
        jfull, _, _ = jlm.forward(jpk, jcfg, {"tokens": jnp.asarray(tokens)},
                                  quant_mode="packed")
    tpre = tsteps.make_prefill_chunk_step(tcfg)
    tl, tcache = tpre(tpk, tcache, {"tokens": tokens}, index, valid)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)
    tl2, _ = tsteps.make_decode_step(tcfg)(tpk, tcache, {"tokens": dec_tok},
                                           index2, valid2)
    np.testing.assert_allclose(tl2.numpy()[:2], np.asarray(jl2)[:2],
                               rtol=1e-3, atol=1e-3)
    tfull, _, _ = tlm.forward(tpk, tcfg, {"tokens": torch.from_numpy(tokens)},
                              quant_mode="packed")
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), rtol=1e-3,
                               atol=1e-3)


def test_steps_update_caches_in_place():
    """The counterpart of tests/test_donation.py: decode and prefill-chunk
    steps write into the preallocated cache tensors (fixed data_ptr)."""
    _, tcfg = _cfgs(4)
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    caches = tlm.init_caches(tcfg, 2, MAX_LEN, device="cpu")
    ptrs = [t.data_ptr() for c in caches for t in c["attn"].values()]
    pre = tsteps.make_prefill_chunk_step(tcfg)
    dec = tsteps.make_decode_step(tcfg)
    toks = np.ones((2, CHUNK), np.int32)
    _, out = pre(tpk, caches, {"tokens": toks}, np.array([0, 0], np.int32),
                 np.array([CHUNK, 4], np.int32))
    assert out is caches
    _, out = dec(tpk, caches, {"tokens": toks[:, :1]},
                 np.array([CHUNK, 4], np.int32), np.array([1, 1], np.int32))
    assert out is caches
    assert [t.data_ptr() for c in caches for t in c["attn"].values()] == ptrs
    assert caches[0]["attn"]["k"][1, 4].any()          # written in place
    assert not caches[0]["attn"]["k"][1, 5:].any()


def test_engine_plans_are_the_ones_dispatched(monkeypatch):
    """The engine fixes one plan per packed layer and row count at init
    (plan_report lists them); the steps' packed matmuls dispatch through
    those same objects, since the planners are memoized."""
    _, tcfg = _cfgs(4)
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = tengine.ServingEngine(tcfg, tp, config=tengine.EngineConfig(
        max_batch=2, max_len=MAX_LEN, prefill_chunk=CHUNK), device="cpu")
    rows = eng.plan_report()
    assert len(rows) == 2 * 7 * tcfg.num_layers      # decode + prefill rows
    assert {(r["op"], r["backend"]) for r in rows} == {("packed_matmul",
                                                         "torch")}
    seen = []
    dispatch = plan_lib.dispatch

    def spy(plan, *args, **kwargs):
        seen.append(plan)
        return dispatch(plan, *args, **kwargs)

    monkeypatch.setattr(plan_lib, "dispatch", spy)
    eng.submit(tengine.Request(0, np.arange(1, 12, dtype=np.int32),
                               max_new_tokens=2))
    eng.run_to_completion()
    # layers of one shape share a plan: compare the sets of objects
    used = {id(p) for p in seen if p.op == "packed_matmul"}
    assert used == {id(p) for p in eng.plans.values()}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

PROMPTS = (5, 11, 17, 9)
NEW = 4


def _serve(module, cfg, params, ecfg, **kw):
    eng = module.ServingEngine(cfg, params, config=ecfg, **kw)
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
    return [r.output for r in reqs], prompts


@functools.lru_cache(maxsize=None)
def _served(kv_bits, dtype, reference):
    """Greedy outputs of one engine run: the port ('port'), the reference
    with its steps compiled ('jit'), or the reference op by op ('eager')."""
    jcfg, tcfg = _cfgs(kv_bits, dtype)
    jp, tp = _params(jcfg, seed=1)
    kw = dict(max_batch=3, max_len=MAX_LEN, prefill_chunk=CHUNK)
    if reference == "port":
        return _serve(tengine, tcfg, tp, tengine.EngineConfig(**kw),
                      device="cpu")
    ecfg = jengine.EngineConfig(**kw)
    if reference == "eager":
        with jax.disable_jit():
            return _serve(jengine, jcfg, jp, ecfg)
    return _serve(jengine, jcfg, jp, ecfg)


@pytest.mark.parametrize("kv_bits,dtype", [(16, "float32"), (4, "float32"),
                                           (2, "float32"), (4, "bfloat16")])
def test_engine_greedy_tokens_identical(kv_bits, dtype):
    """Staggered admissions, chunked prefill with decode riders, ragged
    decode: the port's greedy tokens equal the reference engine's, with the
    reference's steps run op by op so its float rounding is the one its
    source writes down."""
    got, _ = _served(kv_bits, dtype, "port")
    want, _ = _served(kv_bits, dtype, "eager")
    assert all(len(o) == NEW for o in got)
    assert got == want


def _first_divergence(a, b):
    return next((i for i in range(len(a)) if a[i] != b[i]), len(a))


def test_engine_vs_compiled_reference():
    """Against the reference's compiled (jit) steps, under the shipped bf16
    config.  XLA fuses and rounds differently from the ops as written, and
    with 2-bit activations a one-ulp change can flip a lattice value, so
    the compiled reference parts from its own op-by-op run.  Each request's
    first divergence is reported with the compiled reference's top-2 logit
    margin there; the port must agree with the compiled reference at least
    as long as the reference's own op-by-op run does."""
    jcfg, _ = _cfgs(4, "bfloat16")
    jit_out, prompts = _served(4, "bfloat16", "jit")
    eager_out, _ = _served(4, "bfloat16", "eager")
    port_out, _ = _served(4, "bfloat16", "port")
    jp, _ = _params(jcfg, seed=1)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    step = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t},
                                            quant_mode="packed")[0])
    for uid, (w, g, e) in enumerate(zip(jit_out, port_out, eager_out)):
        i = _first_divergence(w, g)
        if i < len(w):
            seq = np.concatenate([prompts[uid], np.asarray(w[:i], np.int32)])
            top = np.sort(np.asarray(step(jpk, jnp.asarray(seq)[None])[0, -1],
                                     np.float32))[-2:]
            print(f"request {uid}: first divergence from the compiled "
                  f"reference at token {i} (reference {w[i]}, port {g[i]}), "
                  f"reference top-2 margin {float(top[1] - top[0]):.4g}")
        assert i >= _first_divergence(w, e), (uid, w, g, e)


# ---------------------------------------------------------------------------
# Device rule and import rule
# ---------------------------------------------------------------------------

def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no CUDA, an entry point left at its default device raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_params(tcfg)
    tp = tlm.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprepare.prepare_serving_params(tp, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.ServingEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.from_repro({"w": np.zeros(2, np.float32)})
    for paged in ({}, {"page_size": 16, "num_pages": 4}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlm.init_caches(tcfg, 2, MAX_LEN, **paged)
        assert tlm.init_caches(tcfg, 2, MAX_LEN, device="cpu", **paged)[0][
            "attn"]["k"].device.type == "cpu"
    with pytest.raises(ValueError, match="requires packed=True"):
        tengine.EngineConfig(autotune=True, packed=False)
    # the VLM builds an engine too, and defaults to the card likewise
    vcfg = tconfigs.get_config("qwen2-vl-2b", reduced=True)
    vp = tlm.init_params(vcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.ServingEngine(vcfg, vp)
    eng = tengine.ServingEngine(vcfg, vp, device="cpu", config=tengine.
                                EngineConfig(max_batch=2, max_len=MAX_LEN))
    assert eng.max_batch == 2 and "frontend_proj" in eng.params


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
