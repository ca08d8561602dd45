"""Serving the recurrent families through the port's engine against the
reference engine run op by op: reduced ``jamba-1.5-large-398b`` (mamba +
MLP, attention + MoE, W2A2) at kv 16 (f32) and kv 4 (bf16), contiguous
and paged, and reduced ``xlstm-1.3b`` (mLSTM, sLSTM; bf16), five requests
through two slots so that admission resets a reused slot's recurrent
rows; greedy tokens equal with the engine's static steps and with the
op-by-op steps.  Also: paging an attention-free stack refused, prefix
sharing off for a hybrid stack, speculation refused, the slot reset in
place, the cache byte counts against the reference's, the paged state's
export / import round trip with the recurrent rows, and the serving prep
(float gate / conv / SSM leaves, plans for exactly the packed leaves).
The card's counterpart (graphed engine = eager) is in
``tests/test_torch_cuda_graphs.py``.
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
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
MAX_LEN, CHUNK, PAGE = 16, 4, 8
PROMPTS = (3, 6, 4, 5, 2)          # five requests through two slots
NEW = 3


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(arch, kv_bits, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=kv_bits)
    return (jconfigs.get_config(arch, reduced=True).replace(quant=JQ(**q),
                                                            **kw),
            tconfigs.get_config(arch, reduced=True).replace(quant=TQ(**q),
                                                            **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, kv_bits, dtype, seed=1):
    jcfg, _ = _cfgs(arch, kv_bits, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.device_get(jp)


def _tparams(arch, kv_bits, dtype):
    return bridge.from_repro(_params(arch, kv_bits, dtype)[1], device="cpu")


def _ecfg(module, paged, **kw):
    return module.EngineConfig(max_batch=2, max_len=MAX_LEN,
                               prefill_chunk=CHUNK, paged=paged,
                               page_size=PAGE, **kw)


def _requests(module, vocab):
    rng = np.random.default_rng(7)
    return [module.Request(i, rng.integers(0, vocab, n).astype(np.int32),
                           max_new_tokens=NEW)
            for i, n in enumerate(PROMPTS)]


def _serve(module, cfg, params, ecfg, eager_steps=False, **kw):
    eng = module.ServingEngine(cfg, params, config=ecfg, **kw)
    if eager_steps:                  # the op-by-op steps of launch/steps.py
        eng._decode = tsteps.make_decode_step(eng.cfg)
        eng._prefill = tsteps.make_prefill_chunk_step(eng.cfg)
    reqs = _requests(module, cfg.vocab_size)
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()                         # later submissions ride mid-stream
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference(arch, kv_bits, dtype, paged):
    """The reference engine's greedy tokens, op by op."""
    jcfg, _ = _cfgs(arch, kv_bits, dtype)
    with jax.disable_jit():
        return _serve(jengine, jcfg, _params(arch, kv_bits, dtype)[0],
                      _ecfg(jengine, paged))


# the reference runs: jamba kv 16 contiguous and kv 4 paged, xlstm; the
# port's other layout at each kv is held to the same tokens (paged and
# contiguous reads agree)
JAMBA_RUNS = {(16, "float32"): False, (4, "bfloat16"): True}


@pytest.mark.parametrize("eager_steps", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits,dtype", list(JAMBA_RUNS))
def test_jamba_tokens_equal_reference(kv_bits, dtype, paged, eager_steps):
    _, tcfg = _cfgs(JAMBA, kv_bits, dtype)
    got = _serve(tengine, tcfg, _tparams(JAMBA, kv_bits, dtype),
                 _ecfg(tengine, paged), eager_steps=eager_steps,
                 device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference(JAMBA, kv_bits, dtype,
                             JAMBA_RUNS[(kv_bits, dtype)])


@pytest.mark.parametrize("eager_steps", [False, True])
def test_xlstm_tokens_equal_reference(eager_steps):
    _, tcfg = _cfgs(XLSTM, 0, "bfloat16")
    got = _serve(tengine, tcfg, _tparams(XLSTM, 0, "bfloat16"),
                 _ecfg(tengine, False), eager_steps=eager_steps,
                 device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference(XLSTM, 0, "bfloat16", False)


def test_paged_attention_free_stack_is_refused():
    jcfg, tcfg = _cfgs(XLSTM, 4, "bfloat16")
    assert tlm.cache_page_bytes(tcfg, PAGE) == 0
    with pytest.raises(ValueError, match="attention-free"):
        tengine.ServingEngine(tcfg, _tparams(XLSTM, 4, "bfloat16"),
                              config=_ecfg(tengine, True), device="cpu")
    with pytest.raises(ValueError, match="attention-free"):
        jengine.ServingEngine(jcfg, _params(XLSTM, 4, "bfloat16")[0],
                              config=_ecfg(jengine, True))


def test_prefix_sharing_off_for_a_hybrid_stack_and_speculation_refused():
    jcfg, tcfg = _cfgs(JAMBA, 4, "bfloat16")
    tp = _tparams(JAMBA, 4, "bfloat16")
    eng = tengine.ServingEngine(tcfg, tp, config=_ecfg(
        tengine, True, prefix_sharing=True), device="cpu")
    ref = jengine.ServingEngine(jcfg, _params(JAMBA, 4, "bfloat16")[0],
                                config=_ecfg(jengine, True,
                                             prefix_sharing=True))
    assert eng._share is False and ref._share is False
    assert eng.capacity_report()["prefix_sharing"] is False
    for arch in (JAMBA, XLSTM):
        _, c = _cfgs(arch, 4, "bfloat16")
        with pytest.raises(ValueError, match="recurrent"):
            tengine.ServingEngine(c, _tparams(arch, 4, "bfloat16"),
                                  config=_ecfg(tengine, False,
                                               speculative_k=2),
                                  device="cpu")


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_reset_slot_restores_fresh_rows_in_place(arch):
    _, tcfg = _cfgs(arch, 4, "bfloat16")
    eng = tengine.ServingEngine(tcfg, _tparams(arch, 4, "bfloat16"),
                                config=_ecfg(tengine, False), device="cpu")
    ptrs = [[t.data_ptr() for sub in c.values() for t in sub.values()]
            for c in eng.caches]
    gen = torch.Generator().manual_seed(0)
    before = []
    for layer in eng.caches:
        for kind, sub in layer.items():
            if kind != "attn":
                for buf in sub.values():
                    buf.copy_(torch.randn(buf.shape, generator=gen))
                    before.append(buf.clone())
    eng._reset_slot(1)
    fresh = tlm.init_caches(tcfg, 2, MAX_LEN, device="cpu")
    i = 0
    for layer, new in zip(eng.caches, fresh):
        for kind, sub in layer.items():
            if kind == "attn":
                continue
            for name, buf in sub.items():
                assert torch.equal(buf[1], new[kind][name][1])
                assert torch.equal(buf[0], before[i][0])
                i += 1
    assert i > 0
    assert ptrs == [[t.data_ptr() for sub in c.values()
                     for t in sub.values()] for c in eng.caches]


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_cache_bytes_equal_reference(arch, reduced, kv_bits):
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=kv_bits)
    jcfg = jconfigs.get_config(arch, reduced=reduced).replace(quant=JQ(**q))
    tcfg = tconfigs.get_config(arch, reduced=reduced).replace(quant=TQ(**q))
    for b, n in ((1, 512), (3, 48)):
        assert tlm.cache_bytes(tcfg, b, n) == jlm.cache_bytes(jcfg, b, n)
    assert tlm.cache_page_bytes(tcfg, 16) == jlm.cache_page_bytes(jcfg, 16)
    if reduced:
        caches = tlm.init_caches(tcfg, 3, 48, device="cpu")
        assert tlm.cache_bytes(tcfg, 3, 48) == sum(
            t.numel() * t.element_size() for c in caches
            for sub in c.values() for t in sub.values())


def test_import_paged_state_round_trips_a_paged_jamba_engine():
    """A drained paged engine's pools and recurrent rows adopted by a
    fresh engine, in place: every leaf equal, the pointers kept, and the
    same next request served to the same tokens."""
    _, tcfg = _cfgs(JAMBA, 4, "bfloat16")
    tp = _tparams(JAMBA, 4, "bfloat16")
    a = tengine.ServingEngine(tcfg, tp, config=_ecfg(tengine, True),
                              device="cpu")
    for r in _requests(tengine, tcfg.vocab_size)[:3]:
        a.submit(r)
    a.run_to_completion()
    caches, meta = a.export_paged_state()
    b = tengine.ServingEngine(tcfg, tp, config=_ecfg(tengine, True),
                              device="cpu")
    ptrs = [t.data_ptr() for c in b.caches for sub in c.values()
            for t in sub.values()]
    b.import_paged_state(caches, meta)
    assert ptrs == [t.data_ptr() for c in b.caches for sub in c.values()
                    for t in sub.values()]
    kinds = set()
    for ca, cb in zip(a.caches, b.caches):
        for kind, sub in ca.items():
            kinds.add(kind)
            for name, t in sub.items():
                assert torch.equal(t, cb[kind][name]), (kind, name)
    assert kinds == {"attn", "mamba"}
    assert b.pool.export_meta() == meta
    outs = []
    for eng in (a, b):
        r = _requests(tengine, tcfg.vocab_size)[3]
        eng.submit(r)
        eng.run_to_completion()
        outs.append(r.output)
    assert outs[0] == outs[1] and len(outs[0]) == NEW


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_serving_prep_packs_only_the_quantized_2d_leaves(arch):
    jcfg, tcfg = _cfgs(arch, 4, "bfloat16")
    jp = _params(arch, 4, "bfloat16")[0]
    tp = _tparams(arch, 4, "bfloat16")
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    floats = {"mamba": ("dt_proj", "conv_w", "conv_b", "A_log", "D"),
              "mlstm": ("if_gate",), "slstm": ("w_gates", "r_gates")}
    packed = {"mamba": ("in_proj", "x_proj", "out_proj"),
              "mlstm": ("up", "q", "k", "v", "down"),
              "slstm": ("ffn_up", "ffn_down")}
    seen = set()
    for i, blk in enumerate(tpk["layers"]):
        kind = tcfg.layer_kind(i)
        seen.add(kind)
        if kind == "attn":
            continue
        for name in floats[kind]:
            leaf = blk[kind][name]
            leaf = leaf if isinstance(leaf, torch.Tensor) else leaf["kernel"]
            assert leaf.is_floating_point(), (kind, name)
        for name in packed[kind]:
            assert "w_packed" in blk[kind][name], (kind, name)
    assert seen == ({"attn", "mamba"} if arch == JAMBA
                    else {"mlstm", "slstm"})
    want = sum(np.asarray(x).nbytes for x in jax.tree.leaves(
        jax.device_get(jpk)) if hasattr(x, "nbytes"))
    # the prep derives each MoE layer's expert lattices and drops their
    # three 4-byte w_steps (the reference keeps them)
    n_moe = sum(tcfg.layer_is_moe(i) for i in range(tcfg.num_layers))
    assert (n_moe > 0) == (arch == JAMBA)
    assert tprepare.serving_param_bytes(tpk) == want - 12 * n_moe
    jplans = jprepare.build_layer_plans(jpk, jcfg, batch_rows=2,
                                        prefill_rows=8)
    tplans = tprepare.build_layer_plans(tpk, tcfg, batch_rows=2,
                                        prefill_rows=8)
    assert sorted(tplans) == sorted(jplans)
    n_packed = sum(1 for i in range(tcfg.num_layers)
                   for _ in packed.get(tcfg.layer_kind(i), ()))
    assert len([k for k in tplans if "@" not in k]) >= n_packed
