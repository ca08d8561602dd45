"""The port's replica-fleet Router (``repro_torch/serve/router.py``) on the
CPU, case for case against ``tests/test_router.py``: least-loaded
placement, spillover under backpressure with TTFT from fleet admission,
session affinity, drain / restore through ``train/checkpoint`` (the paged
replica's warm prefix cache included), the headless and oversize
refusals, the mesh checks, and the fleet's tokens equal to one engine's
and to the reference Router's on the same weights and prompts.  The
reference's ``(data=2, model=2)`` mesh cases run here on a mesh of four
``cpu`` devices."""

import functools
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_paged_kv import shared_prefix_prompts  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import config as jconfig  # noqa: E402
from repro.serve import router as jrouter  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch.mesh import (ServingMesh, make_serving_mesh,  # noqa
                                     replica_meshes)
from repro_torch.serve import config as tconfig  # noqa: E402
from repro_torch.serve.config import EngineConfig, SamplingParams  # noqa
from repro_torch.serve.engine import Metrics, Request, ServingEngine  # noqa
from repro_torch.serve.router import Router, aggregate_reports  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty (and the reference's, for its
    Router): no cache file changes a layout or a plan here."""
    old, jold = autotune.active_cache(), jautotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)
    jautotune.set_active_cache(jold)


def float_cfgs(name="stablelm-1.6b"):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (jconfigs.get_config(name, reduced=True).replace(
                quant=JQ(enabled=False), **kw),
            configs.get_config(name, reduced=True).replace(
                quant=QuantConfig(enabled=False), **kw))


def packed_cfg(w_bits=2, kv_bits=4):
    return configs.get_config("stablelm-1.6b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32",
        quant=QuantConfig(enabled=True, w_bits=w_bits, a_bits=w_bits,
                          lane_dtype="int16", kv_bits=kv_bits))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's reduced float stablelm and the same weights bridged
    into the port."""
    jcfg, cfg = float_cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, bridge.from_repro(jax.device_get(jp), device="cpu")


@pytest.fixture
def tiny():
    _, _, cfg, params = _weights()
    return cfg, params


def init_port_params(cfg):
    from repro_torch.models import lm
    return lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def seeded_prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def fleet_config(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("packed", False)
    kw.setdefault("prefill_chunk", 4)
    return EngineConfig(**kw)


def router(cfg, params, **kw):
    kw.setdefault("config", fleet_config())
    return Router(cfg, params, device="cpu", **kw)


def single_tokens(cfg, params, prompts, sampling, new, econf=None, **kw):
    eng = ServingEngine(cfg, params, config=econf or fleet_config(),
                        device="cpu", **kw)
    for i, (p, sp) in enumerate(zip(prompts, sampling)):
        assert eng.submit(Request(uid=i, prompt=p, max_new_tokens=new,
                                  sampling=sp))
    return {r.uid: tuple(r.output) for r in eng.run_to_completion()}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_least_loaded_placement_spreads(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2)
    handles = [r.submit(p, max_new_tokens=3)
               for p in seeded_prompts(cfg, (5, 5, 5, 5, 5, 5))]
    assert [h.replica for h in handles] == [0, 1, 0, 1, 0, 1]
    done = r.run_to_completion()
    assert len(done) == 6 and all(h.done for h in done)


FLEET_LENS = (7, 3, 11, 5)
FLEET_SAMPLING = (None, (0.8, 5, 3), None, (1.0, 0, 9))


def _sampling(mod):
    return [None if s is None else mod.SamplingParams(
        temperature=s[0], top_k=s[1], seed=s[2]) for s in FLEET_SAMPLING]


def test_fleet_token_identical_to_single_engine_and_reference(tiny):
    """Outputs do not depend on which replica served a request: the port's
    two-replica fleet equals its single engine and the reference's
    two-replica Router (op by op) on the same weights, greedy and seeded
    sampling alike."""
    cfg, params = tiny
    prompts = seeded_prompts(cfg, FLEET_LENS)
    sampling = _sampling(jconfig)
    want = single_tokens(cfg, params, prompts, _sampling(tconfig), 5)

    r = router(cfg, params, replicas=2)
    handles = [r.submit(p, sp, max_new_tokens=5)
               for p, sp in zip(prompts, _sampling(tconfig))]
    r.run_to_completion()
    assert len({h.replica for h in handles}) == 2   # really load-balanced
    got = {h.uid: tuple(h.output) for h in handles}
    assert got == want

    jcfg, jp, _, _ = _weights()
    with jax.disable_jit():
        jr = jrouter.Router(jcfg, jp, replicas=2,
                            config=jconfig.EngineConfig(
                                max_batch=2, max_len=32, packed=False,
                                prefill_chunk=4))
        jh = [jr.submit(p, sp, max_new_tokens=5)
              for p, sp in zip(prompts, sampling)]
        jr.run_to_completion()
    assert [h.replica for h in jh] == [h.replica for h in handles]
    assert {h.uid: tuple(h.output) for h in jh} == got


# ---------------------------------------------------------------------------
# Backpressure -> spillover
# ---------------------------------------------------------------------------

def test_spillover_under_full_replicas(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2,
               config=fleet_config(max_batch=1, max_queue=1))
    handles = [r.submit(p, max_new_tokens=3)
               for p in seeded_prompts(cfg, (4,) * 6)]
    assert [h.replica for h in handles[:2]] == [0, 1]
    assert all(h.replica is None and h.spilled for h in handles[2:])
    assert r.spilled == 4 and r.num_pending == 6

    done = r.run_to_completion()
    assert len(done) == 6 and all(h.done for h in handles)
    fleet = r.metrics_report()["fleet"]
    assert fleet["rejected"] == 0     # spillover is never a rejection
    assert fleet["retired"] == 6
    assert fleet["spill_pending"] == 0 and fleet["spill_peak"] == 4


def test_spilled_requests_keep_fleet_admission_ttft(tiny):
    """TTFT clocks from Router.submit: three requests through one slot,
    the last one's TTFT covers two whole residencies."""
    cfg, params = tiny
    r = router(cfg, params, replicas=1,
               config=fleet_config(max_batch=1, max_queue=1))
    handles = [r.submit(p, max_new_tokens=4)
               for p in seeded_prompts(cfg, (4, 4, 4))]
    r.run_to_completion()
    ttft = r.metrics_report()["fleet"]["ttft_s"]
    assert ttft["p95"] > ttft["p50"] > 0
    last = handles[-1].request
    assert last.first_token_time - last.submit_time \
        > handles[0].request.finish_time - handles[0].request.submit_time


# ---------------------------------------------------------------------------
# Session affinity
# ---------------------------------------------------------------------------

def test_session_affinity_overrides_least_loaded(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2)
    prompts = seeded_prompts(cfg, (5,) * 5)
    first = r.submit(prompts[0], session="alice", max_new_tokens=3)
    assert first.replica == 0
    r.submit(prompts[1], max_new_tokens=3)     # -> 1 (least loaded)
    r.submit(prompts[2], max_new_tokens=3)     # -> 0 (ties to the lowest)
    pinned = r.submit(prompts[3], session="alice", max_new_tokens=3)
    assert pinned.replica == 0                 # the pin wins
    r.run_to_completion()
    assert r.metrics_report()["fleet"]["sessions"] == 1


def test_full_pinned_replica_waits_not_relocates(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2,
               config=fleet_config(max_batch=1, max_queue=2))
    r.submit(seeded_prompts(cfg, (4,))[0], session="bob", max_new_tokens=3)
    r.submit(seeded_prompts(cfg, (4,), seed=2)[0], session="bob",
             max_new_tokens=3)          # fills replica 0's queue of 2
    third = r.submit(seeded_prompts(cfg, (4,), seed=3)[0], session="bob",
                     max_new_tokens=3)
    assert third.spilled and third.replica is None  # replica 1 has room
    r.run_to_completion()
    assert third.replica == 0                       # placed on its pin


# ---------------------------------------------------------------------------
# Drain / restore
# ---------------------------------------------------------------------------

def test_drain_requeues_waiting_requests(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2,
               config=fleet_config(max_batch=1, max_queue=4))
    handles = [r.submit(p, max_new_tokens=3)
               for p in seeded_prompts(cfg, (4,) * 6)]
    assert [h.replica for h in handles] == [0, 1, 0, 1, 0, 1]
    r.step()            # each replica admits its first request to a slot
    info = r.drain(0)
    assert info["requeued"] == 2        # the queued ones; the live one ran
    # requeued at the spillover's front in their FIFO order
    assert [h.uid for h in r._spill] == [2, 4]
    assert handles[2].spilled and handles[4].spilled
    done = r.run_to_completion()
    assert len(done) == 6
    assert handles[2].replica == handles[4].replica == 1
    fleet = r.metrics_report()["fleet"]
    assert fleet["attached"] == 1 and fleet["drains"] == 1
    assert fleet["retired"] == 6        # the drained replica's history


def test_drain_restore_token_identity(tiny, tmp_path):
    """Drain -> checkpoint handoff -> restore is invisible in the tokens,
    and the detached engine is released."""
    cfg, params = tiny
    prompts = seeded_prompts(cfg, (7, 3, 5))
    want = single_tokens(cfg, params, prompts, [None] * 3, 4)

    r = router(cfg, params, replicas=2, checkpoint_dir=tmp_path)
    r.submit(prompts[0], max_new_tokens=4)
    r.run_to_completion()
    gone = weakref.ref(r.engines[0])
    info = r.drain(0)
    assert gone() is None               # params, caches and steps freed
    assert info["checkpoint"] == {"directory": str(tmp_path), "step": 0}
    assert checkpoint.latest_step(tmp_path) == 0
    with pytest.raises(ValueError, match="detached"):
        r.drain(0)

    r.restore(0)
    with pytest.raises(ValueError, match="attached"):
        r.restore(0)
    handles = [r.submit(p, max_new_tokens=4) for p in prompts]
    r.run_to_completion()
    assert {i: tuple(h.output) for i, h in enumerate(handles)} == want
    fleet = r.metrics_report()["fleet"]
    assert fleet["drains"] == 1 and fleet["restores"] == 1
    assert fleet["attached"] == 2


def test_paged_drain_restore_keeps_warm_prefix(tiny, tmp_path):
    """The page pools and the radix index round-trip through the
    checkpoint: the restored replica still prefix-hits on the pre-drain
    prompt and serves the single engine's tokens, which are the reference
    Router's on the same weights."""
    cfg, params = tiny
    kw = dict(max_batch=2, max_len=48, packed=False, prefill_chunk=8,
              paged=True, page_size=16)
    econf = EngineConfig(**kw)
    prompts = shared_prefix_prompts(cfg)
    want = single_tokens(cfg, params, prompts, [None] * 4, 4, econf)

    r = router(cfg, params, config=econf, replicas=1,
               checkpoint_dir=tmp_path)
    r.submit(prompts[0], max_new_tokens=4)
    r.run_to_completion()
    assert r.engines[0].capacity_report()["cached_prefix_pages"] == 2
    r.drain(0)
    eng = r.restore(0)
    assert eng.capacity_report()["cached_prefix_pages"] == 2
    handles = [r.submit(p, max_new_tokens=4) for p in prompts]
    r.run_to_completion()
    got = {i: tuple(h.output) for i, h in enumerate(handles)}
    assert got == want
    assert eng.capacity_report()["prefix_hit_tokens"] > 0

    jcfg, jp, _, _ = _weights()
    with jax.disable_jit():
        jr = jrouter.Router(jcfg, jp, config=jconfig.EngineConfig(**kw),
                            replicas=1, checkpoint_dir=tmp_path / "ref")
        jr.submit(prompts[0], max_new_tokens=4)
        jr.run_to_completion()
        jr.drain(0)
        jr.restore(0)
        jh = [jr.submit(p, max_new_tokens=4) for p in prompts]
        jr.run_to_completion()
    assert {i: tuple(h.output) for i, h in enumerate(jh)} == got


def test_run_to_completion_refuses_headless_spillover(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=1,
               config=fleet_config(max_batch=1, max_queue=1))
    for p in seeded_prompts(cfg, (4,) * 3):
        r.submit(p, max_new_tokens=3)
    r.drain(0)
    assert r.num_pending == 3      # 2 spilled + 1 requeued by drain
    with pytest.raises(RuntimeError, match="restore"):
        r.run_to_completion()
    r.restore(0)
    assert len(r.run_to_completion()) == 3


# ---------------------------------------------------------------------------
# Admission validation, construction, reports
# ---------------------------------------------------------------------------

def test_oversize_request_rejected_at_the_door(tiny):
    cfg, params = tiny
    r = router(cfg, params, config=fleet_config(max_len=16))
    with pytest.raises(ValueError, match="max_len"):
        r.submit(np.zeros(10, np.int32), max_new_tokens=10)


def test_replica_count_validated(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="replicas"):
        router(cfg, params, replicas=0)


def test_mesh_contradicting_replicas_rejected(tiny):
    cfg, params = tiny
    with pytest.warns(UserWarning, match="clamping"):
        mesh = make_serving_mesh(model=1, data=2, device="cpu")
    with pytest.raises(ValueError, match="data"):
        router(cfg, params, mesh=mesh, replicas=3)
    with pytest.raises(ValueError, match="data"):
        router(cfg, params, mesh=ServingMesh([["cpu"], ["cpu"]]),
               replicas=3)


def test_replica_meshes_carve_one_group_a_row():
    mesh = ServingMesh([["cpu", "cpu"], ["cpu", "cpu"]])
    groups = replica_meshes(mesh)
    assert len(groups) == 2
    assert all(g.shape == {"data": 1, "model": 2} for g in groups)
    assert all(tuple(g.axis_names) == ("data", "model") for g in groups)

    class Flat:
        axis_names = ("model",)
    with pytest.raises(ValueError, match="data.*model"):
        replica_meshes(Flat())


def test_aggregate_sums_rates_and_merges_samples():
    """Fleet tok/s is the sum of per-replica rates; percentiles come from
    the union of samples -- the reference's aggregate on the same
    counters."""
    from repro.serve.engine import Metrics as JMetrics
    reps = []
    for cls in (Metrics, JMetrics):
        a, b = cls(), cls()
        a.decode_tokens, a.decode_time_s = 100, 2.0
        b.decode_tokens, b.decode_time_s = 300, 2.0
        a.ttft_s, b.ttft_s = [0.1, 0.2], [0.3, 0.4]
        a.admitted, b.admitted, a.admission_wait_s = 2, 2, 0.4
        reps.append((aggregate_reports if cls is Metrics
                     else jrouter.aggregate_reports)([a, b]))
    rep, ref = reps
    assert rep["decode_tok_s"] == 200.0 and rep["decode_tokens"] == 400
    assert rep["ttft_s"]["mean"] == pytest.approx(0.25)
    assert rep["ttft_s"]["p50"] == pytest.approx(0.25)
    assert rep == ref


def test_reports_and_reset(tiny):
    cfg, params = tiny
    r = router(cfg, params, replicas=2)
    for p in seeded_prompts(cfg, (5, 6, 7)):
        r.submit(p, max_new_tokens=3)
    r.run_to_completion()
    cap = r.capacity_report()
    assert cap["replicas"] == 2 and cap["fleet_slots"] == 4
    rep = r.metrics_report()
    assert rep["fleet"]["retired"] == 3 and len(rep["replica_reports"]) == 2
    r.reset_metrics()
    fleet = r.metrics_report()["fleet"]
    assert fleet["retired"] == 0 and fleet["spilled"] == 0


# ---------------------------------------------------------------------------
# (data, model) mesh fleet: the reference's 8-device lane, here on a mesh
# of cpu devices
# ---------------------------------------------------------------------------

def test_fleet_2x2_token_identical_to_tp2_single():
    """Two 2-way tensor-parallel packed replicas behind the Router serve
    what one 2-way engine and one unsharded engine serve, greedy and
    seeded sampling alike, with the merged fleet metrics populated."""
    cfg = packed_cfg()
    params = init_port_params(cfg)
    prompts = seeded_prompts(cfg, (7, 3, 11, 5, 6))
    sampling = [None, SamplingParams(temperature=0.9, top_k=8, seed=5),
                None, SamplingParams(temperature=0.7, seed=11), None]
    econf = fleet_config(packed=True)
    want = single_tokens(cfg, params, prompts, sampling, 5, econf,
                         mesh=ServingMesh([["cpu", "cpu"]]))
    assert want == single_tokens(cfg, params, prompts, sampling, 5, econf)

    r = Router(cfg, params, config=econf,
               mesh=ServingMesh([["cpu", "cpu"], ["cpu", "cpu"]]))
    handles = [r.submit(p, sp, max_new_tokens=5,
                        session="sess" if i == 2 else None)
               for i, (p, sp) in enumerate(zip(prompts, sampling))]
    r.run_to_completion()
    assert len({h.replica for h in handles}) == 2
    assert {h.uid: tuple(h.output) for h in handles} == want
    rep = r.metrics_report()
    fleet = rep["fleet"]
    assert fleet["replicas"] == fleet["attached"] == 2
    assert fleet["retired"] == 5 and fleet["rejected"] == 0
    assert fleet["decode_tok_s"] > 0 and fleet["ttft_s"]["p95"] > 0
    cap = r.capacity_report()
    assert cap["fleet_slots"] == 4
    assert all(c["shard_plan"]["model_shards"] == 2
               for c in cap["replica_capacity"])
