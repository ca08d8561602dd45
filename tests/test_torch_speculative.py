"""Speculative decoding in the port (``serve/speculative.py``, the draft and
verify steps, the engine's speculative cycle) against the JAX reference:
the counterpart of ``tests/test_speculative.py``.

- ``probs_for``, ``sample_token`` and ``accept_tokens`` equal to
  ``repro``'s on the same inputs and the same numpy generators, and the
  accept rule's marginal is the target's.
- At temperature 0 the speculative engine's tokens are the plain
  engine's: unpacked f32 at k 2 and 4 (acceptance 1.0), paged with prefix
  sharing through the first-token stash (the draft pool drained after),
  a packed W4A4 int32-lane target with a W2 draft (recalibrated), a
  same-bits draft (acceptance 1.0); and equal to ``repro``'s speculative
  engine run op by op.
- ``draft_model_config`` field by field against ``repro``'s; config and
  stack validation.
- The static-buffer draft and verify steps (CUDA graphs on the card,
  eager here) bit-equal to the op-by-op steps.
- Card cases (marked ``cuda``): graphed vs eager draft and verify,
  pointers fixed, launches counted per replay, the engine's five graphs.
  Run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
  tests/test_torch_speculative.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import cache_write  # noqa: E402
from repro_torch.kernels import ulppack_attention  # noqa: E402
from repro_torch.kernels import ulppack_matmul  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402
from repro_torch.serve import speculative as tspec  # noqa: E402
from repro_torch.serve.config import EngineConfig  # noqa: E402
from repro_torch.serve.config import SamplingParams  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def _reference():
    """repro's speculative module (imported inside the tests that use it:
    the card's machine has no JAX)."""
    from repro.serve import speculative as jspec
    return jspec


# ---------------------------------------------------------------------------
# The sampling math against the reference
# ---------------------------------------------------------------------------

SAMPLINGS = [SamplingParams(), SamplingParams(temperature=0.8, top_k=4),
             SamplingParams(temperature=1.5)]


@pytest.mark.parametrize("sp", SAMPLINGS, ids=str)
def test_sampling_primitives_equal_reference(sp):
    from repro.serve.config import SamplingParams as JSP
    jspec = _reference()
    jsp = JSP(temperature=sp.temperature, top_k=sp.top_k, seed=sp.seed)
    rng0 = np.random.default_rng(3)
    rows = rng0.normal(size=(5, 11)) * 2.0
    for row in rows:
        if not sp.greedy:
            np.testing.assert_array_equal(tspec.probs_for(row, sp),
                                          jspec.probs_for(row, jsp))
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        assert [tspec.sample_token(row, sp, a) for _ in range(20)] == \
            [jspec.sample_token(row, jsp, b) for _ in range(20)]
    for drafted in ([int(np.argmax(rows[0])), 3, 7, 1], [0, 0, 0, 0], []):
        w = len(drafted) + 1
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(10):
            assert tspec.accept_tokens(rows[:w], np.array(drafted), sp, a) \
                == jspec.accept_tokens(rows[:w], np.array(drafted), jsp, b)


def test_accept_tokens_greedy_is_argmax_prefix():
    rows = np.full((4, 5), -10.0)
    for i, a in enumerate([2, 0, 3, 1]):
        rows[i, a] = 1.0
    sp, rng = SamplingParams(), np.random.default_rng(0)
    assert tspec.accept_tokens(rows, np.array([2, 0, 4]), sp, rng) \
        == [2, 0, 3]
    assert tspec.accept_tokens(rows, np.array([2, 0, 3]), sp, rng) \
        == [2, 0, 3, 1]
    assert tspec.accept_tokens(rows[:1], np.array([], np.int32), sp,
                               rng) == [2]


@pytest.mark.parametrize("draft_tok", [0, 3])
def test_accept_tokens_marginal_matches_target(draft_tok):
    """The committed first token's marginal is target-only sampling's p,
    whether the draft proposed a likely or an unlikely token."""
    row = np.random.default_rng(42).normal(size=7) * 2.0
    sp = SamplingParams(temperature=0.8, top_k=4)
    p = tspec.probs_for(row, sp)
    trials = 20_000
    counts = np.zeros(7)
    rng = np.random.default_rng(draft_tok)
    for _ in range(trials):
        out = tspec.accept_tokens(row[None].repeat(2, 0),
                                  np.array([draft_tok]), sp, rng)
        counts[out[0]] += 1
    assert 0.5 * np.abs(counts / trials - p).sum() < 0.02


# ---------------------------------------------------------------------------
# The engine: identity with plain decode
# ---------------------------------------------------------------------------

def _float_cfg(name="stablelm-1.6b", **kw):
    return tconfigs.get_config(name, reduced=True).replace(
        param_dtype="float32", compute_dtype="float32",
        quant=TQ(enabled=False), **kw)


def _run(cfg, params, prompts, *, max_new=6, **kw):
    eng = tengine.ServingEngine(cfg, params, config=EngineConfig(
        max_batch=2, max_len=32, prefill_chunk=4, **kw), device="cpu")
    for i, p in enumerate(prompts):
        assert eng.submit(tengine.Request(uid=i, prompt=p,
                                          max_new_tokens=max_new))
    return {r.uid: tuple(r.output) for r in eng.run_to_completion()}, eng


@pytest.fixture(scope="module")
def float_model():
    cfg = _float_cfg()
    params = tlm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 11)]
    return cfg, params, prompts


@pytest.mark.parametrize("k", [2, 4])
def test_engine_speculative_greedy_identity(k, float_model):
    cfg, params, prompts = float_model
    base, _ = _run(cfg, params, prompts, packed=False)
    got, eng = _run(cfg, params, prompts, packed=False, speculative_k=k)
    assert got == base
    rep = eng.metrics.report()
    assert rep["spec_cycles"] > 0 and rep["drafted_tokens"] > 0
    assert rep["acceptance_rate"] == 1.0
    assert rep["accepted_tokens"] <= rep["drafted_tokens"]
    overhead = rep["verify_tokens"] - rep["drafted_tokens"]
    assert rep["spec_cycles"] <= overhead <= 2 * rep["spec_cycles"]


def test_engine_speculative_paged_prefix_sharing_identity(float_model):
    """The target prefix-skips a shared prompt while the draft replays it
    in full (the first-token stash); tokens equal plain paged decode and
    the draft's pool drains back."""
    cfg, params, _ = float_model
    rng = np.random.default_rng(12)
    shared = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    prompts = [shared,
               np.concatenate([shared[:6], rng.integers(
                   0, cfg.vocab_size, 4).astype(np.int32)]),
               shared.copy()]
    kw = dict(packed=False, paged=True, page_size=4, max_new=5)
    base, _ = _run(cfg, params, prompts, **kw)
    got, eng = _run(cfg, params, prompts, speculative_k=3, **kw)
    assert got == base
    assert eng.pool.prefix_hits >= 1
    assert eng.metrics.report()["acceptance_rate"] == 1.0
    assert eng.spec.pool.report()["free_pages"] == eng.spec.num_pages
    rep = eng.capacity_report()["speculative"]
    assert rep["draft_num_pages"] == eng.spec.num_pages == 2 * 8


def _packed_cfg(w, a, lane="int16", kv_bits=0):
    return tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32",
        quant=TQ(enabled=True, w_bits=w, a_bits=a, lane_dtype=lane,
                 kv_bits=kv_bits))


def test_engine_packed_draft_identity_and_report():
    """A W4A4 int32-lane target with a W2 draft (re-packed, scales
    recalibrated), lanes and the dense store: outputs equal target-only
    greedy decode, and the report carries the draft's precision."""
    cfg = _packed_cfg(4, 4, "int32")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3)]
    base, _ = _run(cfg, params, prompts)
    for dense in (False, True):
        got, eng = _run(cfg, params, prompts, speculative_k=2,
                        draft_w_bits=2, dense_store=dense)
        assert got == base
        rep = eng.capacity_report()["speculative"]
        assert rep["draft_packed"] is True and rep["draft_w_bits"] == 2
        assert rep["draft_a_bits"] == 2 and rep["draft_param_bytes"] > 0
        assert eng.spec.cfg.quant.w_bits == 2 and cfg.quant.w_bits == 4
        assert {p.weight_store for p in eng.spec.plans.values()} == {
            "dense" if dense else "lanes"}
        # recalibrated: the draft's scales are not the target's steps
        q = eng.spec.params["layers"][0]["attn"]["q"]
        assert not torch.equal(q["w_scale"], params["layers"][0]["attn"][
            "q"]["w_step"].float())


def test_same_bits_draft_keeps_learned_steps():
    """At the target's bits the repack keeps the learned steps: the draft
    is the target numerically, and greedy acceptance is exactly 1."""
    cfg = _packed_cfg(2, 2, kv_bits=4)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
               for _ in range(2)]
    base, _ = _run(cfg, params, prompts)
    got, eng = _run(cfg, params, prompts, speculative_k=2,
                    draft_w_bits=cfg.quant.w_bits)
    assert got == base
    assert eng.metrics.report()["acceptance_rate"] == 1.0
    q = eng.spec.params["layers"][0]["attn"]["q"]
    assert torch.equal(q["w_scale"],
                       params["layers"][0]["attn"]["q"]["w_step"].float())


# ---------------------------------------------------------------------------
# Config surface
# ---------------------------------------------------------------------------

def test_draft_model_config_equals_reference():
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro.serve.config import EngineConfig as JEC
    jspec = _reference()
    jc = jconfigs.get_config("stablelm-1.6b", reduced=True)
    tc = tconfigs.get_config("stablelm-1.6b", reduced=True)
    for q in (dict(w_bits=4, a_bits=4, lane_dtype="int32", kv_bits=4),
              dict(w_bits=2, a_bits=2, kv_bits=16), dict(w_bits=3, a_bits=1)):
        jcfg = jc.replace(quant=JQ(enabled=True, **q))
        tcfg = tc.replace(quant=TQ(enabled=True, **q))
        for e in (dict(speculative_k=2, draft_w_bits=2),
                  dict(speculative_k=2, draft_w_bits=1, draft_kv_bits=2),
                  dict(speculative_k=2, packed=False)):
            want = jspec.draft_model_config(jcfg, JEC(**e)).quant
            got = tspec.draft_model_config(tcfg, EngineConfig(**e)).quant
            for f in dataclasses.fields(got):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    un = EngineConfig(packed=False, speculative_k=2)
    assert tspec.draft_model_config(tc, un) is tc


def test_config_and_stack_validation():
    with pytest.raises(ValueError, match="speculative_k"):
        EngineConfig(speculative_k=-1)
    with pytest.raises(ValueError, match="draft_w_bits"):
        EngineConfig(speculative_k=2, draft_w_bits=8)
    with pytest.raises(ValueError, match="draft_kv_bits"):
        EngineConfig(speculative_k=2, draft_kv_bits=3)
    EngineConfig(speculative_k=0, draft_w_bits=8)  # unchecked while off
    with pytest.raises(ValueError, match="dense_store"):
        EngineConfig(packed=False, dense_store=True)
    cfg = _float_cfg("mixtral-8x7b").replace(sliding_window=6)
    with pytest.raises(ValueError, match="sliding-window"):
        tengine.ServingEngine(cfg, {}, config=EngineConfig(
            packed=False, speculative_k=2), device="cpu")


# ---------------------------------------------------------------------------
# Against the reference's speculative engine, op by op
# ---------------------------------------------------------------------------

def test_engine_tokens_equal_reference_speculative_engine():
    """A packed W2A2 target (kv 4) with a W1 draft at k 3 -- drafts get
    rejected, so the accept path and the rollback run: the port's greedy
    tokens equal the reference's speculative engine run op by op."""
    import jax
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro.kernels import autotune
    from repro.models import lm as jlm
    from repro.serve import engine as jengine
    from repro_torch import bridge
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=4)
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(**q), **kw)
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(**q), **kw)
    jp = jlm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (6, 3)]
    e = dict(speculative_k=3, draft_w_bits=1)
    got, eng = _run(tcfg, tp, prompts, max_new=5, **e)
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    try:
        jeng = jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(
            max_batch=2, max_len=32, prefill_chunk=4, **e))
        for i, p in enumerate(prompts):
            jeng.submit(jengine.Request(uid=i, prompt=p, max_new_tokens=5))
        with jax.disable_jit():
            want = {r.uid: tuple(r.output)
                    for r in jeng.run_to_completion()}
    finally:
        autotune.set_active_cache(old)
    assert got == want
    rep = eng.metrics.report()
    assert rep["spec_cycles"] > 0 and rep["acceptance_rate"] < 1.0


# ---------------------------------------------------------------------------
# The static-buffer draft and verify steps
# ---------------------------------------------------------------------------

B, K, MAX_LEN, CHUNK, PS = 3, 3, 32, 4, 8


def _spec_model(dev="cpu"):
    cfg = _packed_cfg(2, 2, kv_bits=4)
    tp = tlm.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         dev)
    dcfg = tspec.draft_model_config(cfg, EngineConfig(speculative_k=K,
                                                      draft_w_bits=1))
    return (cfg, tprepare.prepare_serving_params(tp, cfg, device=dev),
            dcfg, tprepare.prepare_serving_params(tp, dcfg, recalibrate=True,
                                                  device=dev))


def _caches(cfg, dev, paged):
    kw = dict(page_size=PS, num_pages=B * MAX_LEN // PS + 1) if paged else {}
    return tlm.init_caches(cfg, B, MAX_LEN, device=dev, **kw)


def _table(paged):
    if not paged:
        return ()
    bt = np.zeros((B, MAX_LEN // PS), np.int32)
    bt[:2] = 1 + np.random.default_rng(1).permutation(
        B * MAX_LEN // PS)[:2 * bt.shape[1]].reshape(2, -1)
    return (bt,)


def _cycles():
    """(prefill tokens, index, valid) then (last tokens, index, limit)
    cycles: row 1 stops short (limit 1), row 2 is dead (limit -1)."""
    rng = np.random.default_rng(6)
    pre = (rng.integers(0, 512, (B, CHUNK)).astype(np.int32),
           np.zeros(B, np.int32), np.array([CHUNK, 3, 0], np.int32))
    cyc = []
    pos = np.array([CHUNK, 3, 0], np.int32)
    for lim in ([K, 1, -1], [K, 0, -1]):
        cyc.append((rng.integers(0, 512, (B, 1)).astype(np.int32),
                    pos.copy(), np.array(lim, np.int32)))
        pos[:2] += np.maximum(np.array(lim[:2]), 0) + 1
    return pre, cyc


def _same_caches(a, b):
    return all(torch.equal(x["attn"][n], y["attn"][n])
               for x, y in zip(a, b) for n in x["attn"])


def _check_static_equals_eager(dev, paged):
    cfg, params, dcfg, dparams = _spec_model(dev)
    extra = _table(paged)
    width = MAX_LEN // PS if paged else None
    ec, gc = _caches(cfg, dev, paged), _caches(cfg, dev, paged)
    edc, gdc = _caches(dcfg, dev, paged), _caches(dcfg, dev, paged)
    st = steps.graphed_speculative_steps(
        cfg, params, gc, dcfg, dparams, gdc, k=K, batch=B,
        prefill_chunk=CHUNK, block_table_width=width,
        draft_block_table_width=width)
    ptrs = {(n, k): v.data_ptr() for n, s in st.items()
            for k, v in s.buffers.items()}
    outs = {n: s.logits.data_ptr() for n, s in st.items()
            if s.logits is not None}
    (tok, idx, vld), cyc = _cycles()
    st["prefill_chunk"](params, gc, {"tokens": tok}, idx, vld, *extra)
    steps.make_prefill_chunk_step(cfg)(params, ec, {"tokens": tok}, idx,
                                       vld, *extra)
    st["draft_prefill"](dparams, gdc, {"tokens": tok}, idx, vld, *extra)
    steps.make_prefill_chunk_step(dcfg)(dparams, edc, {"tokens": tok}, idx,
                                        vld, *extra)
    eager_draft = steps.make_draft_step(dcfg, K)
    eager_verify = steps.make_verify_chunk_step(cfg)
    for last, index, limit in cyc:
        want_d, _ = eager_draft(dparams, edc, {"tokens": last}, index, limit,
                                *extra)
        got_d, _ = st["draft"](dparams, gdc, {"tokens": last}, index, limit,
                               *extra)
        assert got_d.dtype == torch.int32 and got_d.shape == (B, K)
        assert torch.equal(got_d, want_d)
        win = np.concatenate([last, got_d.cpu().numpy()], axis=1)
        valid = np.maximum(limit + 1, 0).astype(np.int32)
        want_v, _ = eager_verify(params, ec, {"tokens": win}, index, valid,
                                 *extra)
        got_v, _ = st["verify"](params, gc, {"tokens": win}, index, valid,
                                *extra)
        assert got_v.shape == (B, K + 1, cfg.padded_vocab)
        assert torch.equal(got_v, want_v)
    if dev != "cpu":
        torch.cuda.synchronize()
    assert _same_caches(ec, gc) and _same_caches(edc, gdc)
    assert {(n, k): v.data_ptr() for n, s in st.items()
            for k, v in s.buffers.items()} == ptrs
    assert {n: s.logits.data_ptr() for n, s in st.items()
            if s.logits is not None} == outs
    # the dead row's draft never wrote: its cache rows are zero (unpaged)
    if not paged:
        assert not gdc[0]["attn"]["k"][2].any()
    return st


@pytest.mark.parametrize("paged", [False, True])
def test_static_draft_and_verify_equal_eager(paged):
    st = _check_static_equals_eager("cpu", paged)
    assert all(s.graph is None for s in st.values())     # the CPU: eager


def test_draft_step_refuses_missing_limit():
    cfg, params, dcfg, dparams = _spec_model()
    st = steps.StaticStep(dcfg, dparams, _caches(dcfg, "cpu", False),
                          kind="draft", batch=B, width=1, k=K)
    assert torch.equal(st.buffers["limit"],
                       torch.full((B,), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="limit"):
        st(dparams, st._caches, {"tokens": np.zeros((B, 1), np.int32)},
           np.zeros(B, np.int32))
    with pytest.raises(ValueError, match="k >= 1"):
        steps.StaticStep(dcfg, dparams, st._caches, kind="draft", batch=B,
                         width=1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_graphed_draft_and_verify_equal_eager(hopper, paged):
    """On the card all five steps are CUDA graphs over one frozen split-K
    workspace; the draft and verify replays equal the op-by-op steps bit
    for bit, their buffers and outputs stay put."""
    st = _check_static_equals_eager(hopper, paged)
    assert all(s.graph is not None for s in st.values())
    assert len({id(s.workspace) for s in st.values()}) == 1
    assert st["draft"].workspace.frozen


@pytest.mark.cuda
def test_draft_and_verify_replays_count_their_launches(hopper):
    """A draft replay launches k + 1 forwards' kernels (one fused K2 a
    packed linear, one attention kernel and one cache write a layer), a
    verify replay one forward's, on the dense store too."""
    cfg, params, dcfg, dparams = _spec_model(hopper)
    n = cfg.num_layers
    st = steps.graphed_speculative_steps(
        cfg, params, _caches(cfg, hopper, False), dcfg, dparams,
        _caches(dcfg, hopper, False), k=K, batch=B, prefill_chunk=CHUNK)
    for mod in (ulppack_matmul, ulppack_attention, cache_write):
        mod.reset_counts()
    one, idx = np.array([K, K, -1], np.int32), np.zeros(B, np.int32)
    st["draft"](dparams, st["draft"]._caches,
                {"tokens": np.ones((B, 1), np.int32)}, idx, one)
    torch.cuda.synchronize()
    assert ulppack_matmul.mma_launches["quant_affine"] == (K + 1) * 7 * n
    assert ulppack_attention.kernel_launches["attention_decode"] == \
        (K + 1) * n
    assert cache_write.kernel_launches["cache_write"] == (K + 1) * n
    st["verify"](params, st["verify"]._caches,
                 {"tokens": np.ones((B, K + 1), np.int32)}, idx,
                 np.array([K + 1, 2, 0], np.int32))
    torch.cuda.synchronize()
    assert ulppack_matmul.mma_launches["quant_affine"] == (K + 2) * 7 * n
    assert not any(ulppack_attention.plain_calls.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_engine_speculative_graphed_tokens_equal_plain(hopper, dense):
    """The speculative engine on the card (five graphs) gives the plain
    graphed engine's greedy tokens with a same-bits draft (acceptance
    1.0) and a W1 draft, lanes and dense store."""
    cfg = _packed_cfg(2, 2, kv_bits=4)
    params = tlm.init_params(cfg, torch.Generator(device=hopper)
                             .manual_seed(8), hopper)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 11)]

    def run(**kw):
        eng = tengine.ServingEngine(cfg, params, config=EngineConfig(
            max_batch=2, max_len=32, prefill_chunk=4, dense_store=dense,
            **kw), device=hopper)
        for i, p in enumerate(prompts):
            eng.submit(tengine.Request(uid=i, prompt=p, max_new_tokens=6))
        return {r.uid: tuple(r.output) for r in eng.run_to_completion()}, eng

    base, _ = run()
    same, eng = run(speculative_k=3, draft_w_bits=2)
    assert same == base and eng.metrics.report()["acceptance_rate"] == 1.0
    assert eng._verify.graph is not None and eng.spec.draft_step.graph \
        is not None and eng.spec.prefill_step.graph is not None
    low, eng = run(speculative_k=3, draft_w_bits=1)
    assert low == base
