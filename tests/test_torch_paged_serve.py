"""The port's paged serving engine at reduced size (``stablelm-1.6b
--reduced``, W2A2, f32, ``max_len=48``, ``page_size=16``,
``prefill_chunk=8``) with ``tests/test_paged_kv.py``'s shared-prefix
prompts: greedy tokens equal the reference's paged engine run op by op,
paged equals unpaged in the port (prefix hits and copy-on-write firing),
the fixed-budget capacity test reproduces the reference's page counts,
``capacity_report()``'s paged keys equal the reference's, the paged state
round-trips, and the rejections match."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_paged_kv import shared_prefix_prompts  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import ulppack_attention  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.prepare import cache_bytes_per_slot  # noqa: E402

torch.set_num_threads(2)

MAX_LEN, CHUNK, PAGE, NEW = 48, 8, 16, 4
PAGED_KEYS = ("paged", "page_size", "page_bytes", "num_pages",
              "pages_per_slot", "guaranteed_slots", "peak_live_slot_count",
              "prefix_sharing", "free_pages", "live_pages", "shared_pages",
              "cached_prefix_pages", "prefix_hits", "prefix_hit_tokens",
              "cow_copies", "evicted_pages", "cache_bytes_per_slot", "slots")


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
    """Pin the reference's lane layouts to the config's base spec (an empty
    tuning cache), the only layout the port serves."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _cfgs(kv_bits, quant=True):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jc = jconfigs.get_config("stablelm-1.6b", reduced=True)
    tc = tconfigs.get_config("stablelm-1.6b", reduced=True)
    return (jc.replace(quant=JQ(enabled=quant, w_bits=2, a_bits=2,
                                kv_bits=kv_bits), **kw),
            tc.replace(quant=TQ(enabled=quant, w_bits=2, a_bits=2,
                                kv_bits=kv_bits), **kw))


@functools.lru_cache(maxsize=None)
def _params(kv_bits, quant=True):
    jcfg, _ = _cfgs(kv_bits, quant)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.from_repro(jax.device_get(jp), device="cpu")


def _serve(module, cfg, params, prompts, **kw):
    eng_kw = {"device": "cpu"} if module is tengine else {}
    ekw = dict(max_batch=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
               page_size=PAGE)
    ekw.update(kw)
    eng = module.ServingEngine(cfg, params,
                               config=module.EngineConfig(**ekw), **eng_kw)
    for i, p in enumerate(prompts):
        assert eng.submit(module.Request(uid=i, prompt=p,
                                         max_new_tokens=NEW))
    out = {r.uid: tuple(r.output) for r in eng.run_to_completion()}
    return out, eng


@functools.lru_cache(maxsize=None)
def _served(kv_bits, who, paged=True):
    """Greedy outputs and capacity report of one engine run: the port, or
    the reference's engine op by op (``jax.disable_jit()``)."""
    jcfg, tcfg = _cfgs(kv_bits)
    jp, tp = _params(kv_bits)
    prompts = shared_prefix_prompts(tcfg)
    if who == "port":
        out, eng = _serve(tengine, tcfg, tp, prompts, paged=paged)
    else:
        with jax.disable_jit():
            out, eng = _serve(jengine, jcfg, jp, prompts, paged=paged)
    return out, eng.capacity_report()


@pytest.mark.parametrize("kv_bits", [4, 2])
def test_paged_tokens_equal_reference_paged_engine(kv_bits):
    got, rep = _served(kv_bits, "port")
    want, jrep = _served(kv_bits, "reference")
    assert all(len(o) == NEW for o in got.values())
    assert got == want
    assert {k: rep[k] for k in PAGED_KEYS} == {k: jrep[k] for k in PAGED_KEYS}


@pytest.mark.parametrize("kv_bits", [16, 4, 2])
def test_paged_equals_unpaged(kv_bits):
    """Block-table indirection is invisible in the tokens, while prefix
    hits and copy-on-write fire; every paged read went through the paged
    attention path and none through the contiguous one."""
    _, tcfg = _cfgs(kv_bits)
    _, tp = _params(kv_bits)
    ulppack_attention.reset_counts()
    got, eng = _serve(tengine, tcfg, tp, shared_prefix_prompts(tcfg),
                      paged=True)
    calls = dict(ulppack_attention.plain_calls)
    want, _ = _served(kv_bits, "port", paged=False)
    assert got == want
    rep = eng.capacity_report()
    assert rep["paged"] and rep["prefix_sharing"]
    assert rep["prefix_hit_tokens"] >= 16
    assert rep["cow_copies"] >= 1
    assert rep["pages_per_slot"] == 3
    assert calls["attention_decode_paged"] == eng.metrics.steps \
        * tcfg.num_layers and calls["attention_decode"] == 0


def test_paged_without_sharing_matches():
    _, tcfg = _cfgs(4)
    _, tp = _params(4)
    got, eng = _serve(tengine, tcfg, tp, shared_prefix_prompts(tcfg),
                      paged=True, prefix_sharing=False)
    want, _ = _served(4, "port", paged=False)
    assert got == want
    rep = eng.capacity_report()
    assert not rep["prefix_sharing"] and rep["prefix_hit_tokens"] == 0


def test_fixed_budget_doubles_logical_slots():
    """The reference test's own settings (``max_len=40``, ``page_size=8``,
    kv_bits 4, ``packed=False``, a budget of 3 unpaged slots): the same
    page counts, >= 2x the logical slots, tokens equal to the unpaged
    engine."""
    _, tcfg = _cfgs(4, quant=False)
    _, tp = _params(4, quant=False)
    max_len, ps = 40, 8
    budget = 3 * cache_bytes_per_slot(tcfg, max_len)
    base = dict(max_len=max_len, packed=False, prefill_chunk=8,
                hbm_cache_budget=budget)
    unpaged = tengine.ServingEngine(tcfg, tp, device="cpu",
                                    config=tengine.EngineConfig(**base))
    assert unpaged.max_batch == 3
    paged = tengine.ServingEngine(
        tcfg, tp, device="cpu", config=tengine.EngineConfig(
            max_batch=8, paged=True, page_size=ps, **base))
    rep = paged.capacity_report()
    assert (rep["num_pages"], rep["pages_per_slot"],
            rep["guaranteed_slots"]) == (15, 5, 3)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, tcfg.vocab_size, 24).astype(np.int32)
    assert paged.submit(tengine.Request(uid=99, prompt=prefix,
                                        max_new_tokens=1))
    paged.run_to_completion()
    assert paged.capacity_report()["cached_prefix_pages"] == 3
    paged.peak_live_slots = 0
    prompts = [np.concatenate([prefix, [i]]).astype(np.int32)
               for i in range(8)]
    for i, p in enumerate(prompts):
        assert paged.submit(tengine.Request(uid=i, prompt=p,
                                            max_new_tokens=2))
    got = {r.uid: tuple(r.output) for r in paged.run_to_completion()}
    rep = paged.capacity_report()
    assert rep["peak_live_slot_count"] >= 2 * unpaged.max_batch
    assert rep["prefix_hits"] >= 8 and rep["prefix_hit_tokens"] >= 8 * 24
    for i, p in enumerate(prompts):
        assert unpaged.submit(tengine.Request(uid=i, prompt=p,
                                              max_new_tokens=2))
    want = {r.uid: tuple(r.output) for r in unpaged.run_to_completion()}
    assert got == want


def test_paged_state_round_trip_keeps_warm_prefix():
    """export_paged_state -> import_paged_state carries the pools and the
    radix index into a fresh engine: it prefix-hits on the exported prompt
    and serves the same tokens."""
    _, tcfg = _cfgs(4)
    _, tp = _params(4)
    prompts = shared_prefix_prompts(tcfg)
    want, _ = _served(4, "port")
    cfg = tengine.EngineConfig(max_batch=2, max_len=MAX_LEN,
                               prefill_chunk=CHUNK, paged=True,
                               page_size=PAGE)
    first = tengine.ServingEngine(tcfg, tp, config=cfg, device="cpu")
    first.submit(tengine.Request(uid=0, prompt=prompts[0],
                                 max_new_tokens=NEW))
    first.run_to_completion()
    caches, meta = first.export_paged_state()
    assert meta["nodes"] and first.capacity_report()[
        "cached_prefix_pages"] == 2
    second = tengine.ServingEngine(tcfg, tp, config=cfg, device="cpu")
    ptrs = [t.data_ptr() for c in second.caches for t in c["attn"].values()]
    second.import_paged_state(caches, meta)
    assert [t.data_ptr() for c in second.caches
            for t in c["attn"].values()] == ptrs
    assert second.capacity_report()["cached_prefix_pages"] == 2
    for i, p in enumerate(prompts):
        second.submit(tengine.Request(uid=i, prompt=p, max_new_tokens=NEW))
    got = {r.uid: tuple(r.output) for r in second.run_to_completion()}
    assert got == want
    assert second.capacity_report()["prefix_hit_tokens"] > 0
    unpaged = tengine.ServingEngine(tcfg, tp, device="cpu",
                                    config=tengine.EngineConfig(max_len=32))
    with pytest.raises(ValueError, match="unpaged engine"):
        unpaged.export_paged_state()


def test_paged_rejections():
    _, tcfg = _cfgs(4)
    _, tp = _params(4)
    with pytest.raises(ValueError, match="sliding-window"):
        tengine.ServingEngine(tcfg.replace(sliding_window=8), tp,
                              device="cpu", config=tengine.EngineConfig(
                                  max_len=32, paged=True))
    with pytest.raises(ValueError, match="word-packing tail"):
        tengine.ServingEngine(tcfg, tp, device="cpu",
                              config=tengine.EngineConfig(
                                  max_len=32, paged=True, page_size=4))
    with pytest.raises(ValueError, match="page_size"):
        tengine.EngineConfig(paged=True, page_size=0)
    with pytest.raises(ValueError, match="worst-case"):
        tengine.EngineConfig(max_len=32, paged=True, page_size=8,
                             hbm_cache_budget=10).pages_for(100, 4)
