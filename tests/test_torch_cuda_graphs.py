"""The compiled serving steps on the card: ``csrc/cache_write.cu`` against
its plain twin, and the decode / prefill-chunk steps captured as CUDA
graphs (``launch/steps.graphed_serving_steps``) against the op-by-op
steps.  Marked ``cuda``: every test skips (inside the ``hopper`` fixture,
never at import) unless a CUDA device of capability (9, 0) or newer is
present.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py

Everything is compared bit for bit: a replay runs the kernels the eager
step launches, on the same inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import cache_write, ulppack_attention  # noqa: E402
from repro_torch.kernels import ulppack_matmul  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402
from repro_torch.serve import prepare  # noqa: E402

pytestmark = pytest.mark.cuda

B, SQ, S, H, KVH = 3, 8, 24, 4, 2
PS, NP = 8, 3
P = B * NP + 3
RAGGED = (([0, 0, 5], [8, 3, 0]), ([8, S - 2, 0], [1, 8, 1]),
          ([S + 1, 3, 20], [8, 0, 8]))
PAGED = (([0, 0, 0], [8, 3, 0]), ([8, 3, 0], [1, 8, 0]),
         ([NP * PS - 3, 11, 0], [6, 8, 0]))
CHUNK, MAX_LEN = 8, 32


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _cfg(kv_bits=4, **kw):
    c = configs.get_config("stablelm-1.6b", reduced=True)
    return c.replace(quant=QuantConfig(enabled=True, w_bits=2, a_bits=2,
                                       kv_bits=kv_bits), **kw)


def _same(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_write_bit_equal(hopper, kv_bits, paged):
    """Every window of the CPU test's cases, written by the kernel and by
    its plain twin on the same device: the same bytes, one launch a
    window, page 0 and the unmapped pages untouched."""
    cfg = _cfg(kv_bits, num_heads=H, num_kv_heads=KVH)
    make = ((lambda: attention.init_paged_kv_cache(cfg, P, PS,
                                                   device=hopper))
            if paged else (lambda: attention.init_kv_cache(cfg, B, S,
                                                           device=hopper)))
    got, want = make(), make()
    rng = np.random.default_rng(kv_bits)
    bt = np.zeros((B, NP), np.int32)
    bt[:2] = (1 + rng.permutation(P - 3)[:2 * NP]).reshape(2, NP)
    tbt = torch.from_numpy(bt).to(hopper)
    hd = cfg.resolved_head_dim
    cache_write.reset_counts()
    for idx, vlen in (PAGED if paged else RAGGED):
        k, v = (torch.from_numpy(rng.standard_normal(
            (B, SQ, KVH, hd)).astype(np.float32)).to(hopper)
            for _ in range(2))
        ti = torch.tensor(idx, dtype=torch.int32, device=hopper)
        tv = torch.tensor(vlen, dtype=torch.int32, device=hopper)
        dest = (attention.paged_dest_rows(ti, tv, tbt, SQ, PS, P) if paged
                else attention.ragged_dest_rows(ti, tv, SQ, S))
        attention.cache_write(got, k, v, dest, kv_bits, backend="cuda")
        attention.cache_write(want, k, v, dest, kv_bits, backend="torch")
    torch.cuda.synchronize()
    assert cache_write.kernel_launches["cache_write"] == 3
    for name in want:
        assert _same(got[name], want[name]), name
    if paged:
        assert not got["k"][0].any() and not got["k"][P - 2:].any()


@pytest.mark.parametrize("unit_rows", [1, 2, 3, 512])
def test_cache_write_last_writer_and_units(hopper, unit_rows):
    """Shared destinations (the later token wins), out-of-range rows and
    rows of 2 to 1,024 bytes, against the twin."""
    g = torch.Generator(device=hopper).manual_seed(unit_rows)
    dest = torch.tensor([3, 1, 3, -1, 9, 1, 7, 0], dtype=torch.int64,
                        device=hopper)
    leaves = [(torch.zeros((8, unit_rows), dtype=dt, device=hopper),
               torch.randint(-99, 99, (8, unit_rows), generator=g,
                             device=hopper).to(dt))
              for dt in (torch.int16, torch.int32, torch.int8,
                         torch.bfloat16)]
    twin = [(d.clone(), s) for d, s in leaves]
    cache_write.cache_write_cuda(dest, leaves)
    cache_write.cache_write_torch(dest, twin)
    for (a, _), (b, _) in zip(leaves, twin):
        assert _same(a, b)


def _schedule(rng):
    tok = lambda w: rng.integers(0, 512, (B, w)).astype(np.int32)  # noqa
    out = [("prefill", tok(CHUNK), [0, 0, 0], [CHUNK, 5, 0]),
           ("prefill", tok(CHUNK), [CHUNK, 5, 0], [1, CHUNK, 0])]
    pos = np.array([CHUNK + 1, 5 + CHUNK, 0])
    for _ in range(4):
        out.append(("decode", tok(1), pos.copy(), [1, 1, 0]))
        pos[:2] += 1
    return out


def _pair(cfg, dev, paged, batch=B, chunk=CHUNK, seed=0):
    params = prepare.prepare_serving_params(
        lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                       device=dev), cfg, device=dev)
    kw = dict(page_size=PS, num_pages=P) if paged else {}

    def make():
        return lm.init_caches(cfg, batch, MAX_LEN, device=dev, **kw)

    eager_c, graph_c = make(), make()
    pair = steps.graphed_serving_steps(
        cfg, params, graph_c, batch=batch, prefill_chunk=chunk,
        block_table_width=MAX_LEN // PS if paged else None)
    return params, eager_c, graph_c, pair


@pytest.mark.parametrize("paged", [False, True])
def test_graphed_steps_equal_eager(hopper, paged):
    cfg = _cfg(4)
    params, eager_c, graph_c, (dec, pre) = _pair(cfg, hopper, paged)
    assert dec.graph is not None and pre.graph is not None
    eager = {"decode": steps.make_decode_step(cfg),
             "prefill": steps.make_prefill_chunk_step(cfg)}
    graphed = {"decode": dec, "prefill": pre}
    bt = None
    if paged:
        bt = np.zeros((B, MAX_LEN // PS), np.int32)
        bt[:2] = 1 + np.random.default_rng(1).permutation(
            P - 1)[:2 * bt.shape[1]].reshape(2, -1)
    extra = () if bt is None else (bt,)
    ptrs = {(s.kind, k): v.data_ptr() for s in (dec, pre)
            for k, v in s.buffers.items()}
    outs = {s.kind: s.logits.data_ptr() for s in (dec, pre)}
    cache_ptrs = steps._ptrs(graph_c)
    for kind, tok, idx, vld in _schedule(np.random.default_rng(5)):
        args = ({"tokens": tok}, np.asarray(idx, np.int32),
                np.asarray(vld, np.int32), *extra)
        want, _ = eager[kind](params, eager_c, *args)
        got, _ = graphed[kind](params, graph_c, *args)
        assert torch.equal(got, want), kind
    torch.cuda.synchronize()
    for a, b in zip(eager_c, graph_c):
        for name in a["attn"]:
            assert _same(a["attn"][name], b["attn"][name]), name
    assert {(s.kind, k): v.data_ptr() for s in (dec, pre)
            for k, v in s.buffers.items()} == ptrs
    assert {s.kind: s.logits.data_ptr() for s in (dec, pre)} == outs
    assert steps._ptrs(graph_c) == cache_ptrs
    assert (dec.replays, pre.replays) == (4, 2)
    if paged:
        assert not graph_c[0]["attn"]["k"][0].any()


def test_replays_count_their_launches(hopper):
    """Each replay adds the graph's launches: per decode pass one fused K2
    a packed linear, one attention kernel and one cache write a layer."""
    cfg = _cfg(4)
    params, _, graph_c, (dec, _) = _pair(cfg, hopper, False)
    for mod in (ulppack_matmul, ulppack_attention, cache_write):
        mod.reset_counts()
    one = np.ones(B, np.int32)
    for i in range(3):
        dec(params, graph_c, {"tokens": np.ones((B, 1), np.int32)},
            np.full(B, i, np.int32), one)
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert ulppack_matmul.mma_launches["quant_affine"] == 3 * 7 * n
    assert ulppack_attention.kernel_launches["attention_decode"] == 3 * n
    assert cache_write.kernel_launches["cache_write"] == 3 * n
    assert not any(ulppack_attention.plain_calls.values())
    assert not cache_write.plain_calls["cache_write"]


def test_later_capture_cannot_move_the_workspace(hopper):
    """At stablelm-1.6b's widths (one layer) the decode K2 splits K, so
    the pair's workspace is real; a second pair at more rows, captured
    later, gets its own, and the first pair's pointers and replays stay
    as they were."""
    cfg = _cfg(4, num_layers=1, d_model=2048, num_heads=32, num_kv_heads=32,
               d_ff=5632)
    params, eager_c, graph_c, (dec, pre) = _pair(cfg, hopper, False,
                                                batch=2, chunk=4)
    ws = dec.workspace
    assert ws is pre.workspace and ws.frozen and ws.work.numel() > 1
    before = (ws.work.data_ptr(), ws.tickets.data_ptr())
    _, _, _, (dec2, _) = _pair(cfg, hopper, False, batch=4, chunk=16, seed=1)
    assert dec2.workspace is not ws
    assert (ws.work.data_ptr(), ws.tickets.data_ptr()) == before
    eager = steps.make_decode_step(cfg)
    one = np.ones(2, np.int32)
    for i in range(2):
        args = ({"tokens": np.full((2, 1), 7 + i, np.int32)},
                np.full(2, i, np.int32), one)
        want, _ = eager(params, eager_c, *args)
        got, _ = dec(params, graph_c, *args)
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="frozen"):
        ws.get(ws.work.numel() + 1, 1)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_graphed_tokens_equal_eager(hopper, paged):
    """The engine on graphs and the same engine on the op-by-op pair give
    the same greedy tokens."""
    cfg = _cfg(4)
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(2),
                            device=hopper)
    ecfg = engine_lib.EngineConfig(max_batch=3, max_len=48, prefill_chunk=8,
                                   paged=paged, page_size=16)
    outs = []
    for graphed in (True, False):
        eng = engine_lib.ServingEngine(cfg, params, config=ecfg,
                                       device=hopper)
        assert eng.capacity_report()["step_graphs"]
        if not graphed:
            eng._decode = steps.make_decode_step(cfg)
            eng._prefill = steps.make_prefill_chunk_step(cfg)
        rng = np.random.default_rng(7)
        reqs = [engine_lib.Request(i, rng.integers(0, 512, n).astype(
            np.int32), max_new_tokens=6) for i, n in enumerate((5, 11, 17))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def _shard_tokens(cfg, params, dev, mesh=None, paged=False):
    eng = engine_lib.ServingEngine(
        cfg, params, device=dev, mesh=mesh, config=engine_lib.EngineConfig(
            max_batch=3, max_len=48, prefill_chunk=8, paged=paged,
            page_size=16))
    rng = np.random.default_rng(7)
    reqs = [engine_lib.Request(i, rng.integers(0, 512, n).astype(np.int32),
                               max_new_tokens=6)
            for i, n in enumerate((5, 11, 17))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("paged", [False, True])
def test_two_shards_on_one_card_graphed_tokens_equal(hopper, paged):
    """Tensor-parallel serving with both shards on the card: the steps are
    captured over each shard's own K2, K3 / K4 and window-write launches
    (twice the one-shard engine's K2 and reads a pass), and the tokens are
    the one-shard engine's."""
    from repro_torch.launch.mesh import ServingMesh
    cfg = _cfg(4)
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(2),
                            device=hopper)
    want, one = _shard_tokens(cfg, params, hopper, paged=paged)
    got, two = _shard_tokens(cfg, params, hopper, paged=paged,
                             mesh=ServingMesh([[hopper, hopper]]))
    assert two.capacity_report()["step_graphs"]
    assert got == want
    read = "attention_decode_paged" if paged else "attention_decode"
    for key, name in (((ulppack_matmul, "mma_launches"), "quant_affine"),
                      ((ulppack_attention, "kernel_launches"), read)):
        assert two._decode.launches[key][name] \
            == 2 * one._decode.launches[key][name]


def test_two_distinct_cards_step_eagerly(hopper):
    """Shards on two cards: no graph spans devices, so the steps run
    eagerly (``step_graphs`` false) and the tokens are the one-shard
    engine's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.launch.mesh import ServingMesh
    cfg = _cfg(4)
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(2),
                            device=hopper)
    want, _ = _shard_tokens(cfg, params, hopper)
    got, two = _shard_tokens(cfg, params, hopper, mesh=ServingMesh(
        [[torch.device("cuda", 0), torch.device("cuda", 1)]]))
    assert not two.capacity_report()["step_graphs"]
    assert got == want


@pytest.mark.parametrize("paged", [False, True])
def test_two_shards_on_one_card_speculative_graphed(hopper, paged):
    """A speculative engine (k = 2, a W2 draft) with both shards on the
    card: all five steps captured, the draft's K2 launches twice the
    one-shard draft's, and the tokens and acceptance counts the one-shard
    speculative engine's."""
    from repro_torch.launch.mesh import ServingMesh
    cfg = _cfg(4)
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(2),
                            device=hopper)
    runs = {}
    for n, mesh in ((1, None), (2, ServingMesh([[hopper, hopper]]))):
        eng = engine_lib.ServingEngine(
            cfg, params, device=hopper, mesh=mesh,
            config=engine_lib.EngineConfig(
                max_batch=3, max_len=48, prefill_chunk=8, paged=paged,
                page_size=16, speculative_k=2, draft_w_bits=2))
        rng = np.random.default_rng(7)
        reqs = [engine_lib.Request(i, rng.integers(0, 512, m).astype(
            np.int32), max_new_tokens=6) for i, m in enumerate((5, 11, 17))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        steps_ = (eng._decode, eng._prefill, eng._verify,
                  eng.spec.prefill_step, eng.spec.draft_step)
        assert all(st.graph is not None for st in steps_)
        m = eng.metrics
        runs[n] = ([r.output for r in reqs],
                   (m.drafted_tokens, m.accepted_tokens, m.spec_cycles),
                   eng.spec.draft_step.launches[
                       (ulppack_matmul, "mma_launches")]["quant_affine"])
    assert runs[2][:2] == runs[1][:2]
    assert runs[2][2] == 2 * runs[1][2]


@pytest.mark.parametrize("name", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_two_shards_on_one_card_recurrent_graphed(hopper, name):
    """Reduced xlstm and jamba with channel-split states, both shards on
    the card, graphed: the tokens are the one-shard engine's and every
    state after the run is within ``CHANNEL_SPLIT_RTOL`` of one shard's."""
    from repro_torch.launch.mesh import ServingMesh
    from repro_torch.parallel import sharding
    cfg = configs.get_config(name, reduced=True).replace(quant=QuantConfig(
        enabled=True, w_bits=2, a_bits=2, kv_bits=4))
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(2),
                            device=hopper)
    runs = {}
    for n, mesh in ((1, None), (2, ServingMesh([[hopper, hopper]]))):
        toks, eng = _shard_tokens(cfg, params, hopper, mesh=mesh)
        assert eng.capacity_report()["step_graphs"]
        runs[n] = toks, {(i, k, leaf): sharding.whole(t).float()
                         for i, layer in enumerate(eng.caches)
                         for k, sub in layer.items() if k != "attn"
                         for leaf, t in sub.items()}
    assert runs[2][0] == runs[1][0]
    for key, want in runs[1][1].items():
        scale = float(want.abs().max()) or 1.0
        assert float((runs[2][1][key] - want).abs().max()) \
            <= sharding.CHANNEL_SPLIT_RTOL * scale, key


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_moe_ring_engine_graphed_tokens_equal_eager(hopper, kv_bits):
    """Reduced mixtral-8x7b (MoE FFNs, a ring of 8 slots): the engine on
    graphs -- the einsum MoE and the ring's legacy read captured -- and on
    the op-by-op pair give the same greedy tokens, past the wrap; no read
    reaches K3 (windowed caches take the legacy read)."""
    cfg = configs.get_config("mixtral-8x7b", reduced=True)
    cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(3),
                            device=hopper)
    ecfg = engine_lib.EngineConfig(max_batch=3, max_len=MAX_LEN)
    outs = []
    for graphed in (True, False):
        ulppack_attention.reset_counts()
        eng = engine_lib.ServingEngine(cfg, params, config=ecfg,
                                       device=hopper)
        assert eng.capacity_report()["step_graphs"]
        assert eng.prefill_chunk == 1
        if not graphed:
            eng._decode = steps.make_decode_step(cfg)
            eng._prefill = steps.make_prefill_chunk_step(cfg)
        rng = np.random.default_rng(7)
        reqs = [engine_lib.Request(i, rng.integers(0, 512, n).astype(
            np.int32), max_new_tokens=6) for i, n in enumerate((5, 11, 17))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        outs.append([r.output for r in reqs])
        assert not ulppack_attention.kernel_launches["attention_decode"]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch,kv_bits,paged", [
    ("jamba-1.5-large-398b", 16, False), ("jamba-1.5-large-398b", 4, True),
    ("xlstm-1.3b", 0, False)])
def test_recurrent_engine_graphed_tokens_equal_eager(hopper, arch, kv_bits,
                                                     paged):
    """Reduced jamba (mamba + attention, MoE) and xlstm (mLSTM, sLSTM):
    five requests through two slots -- the recurrent states advanced in
    place by every replay and reset at admission -- give the same greedy
    tokens on graphs as on the op-by-op pair; the states stay at their
    addresses."""
    cfg = configs.get_config(arch, reduced=True)
    cfg = cfg.replace(quant=cfg.quant.replace(kv_bits=kv_bits))
    params = lm.init_params(cfg, torch.Generator(device=hopper).manual_seed(4),
                            device=hopper)
    ecfg = engine_lib.EngineConfig(max_batch=2, max_len=MAX_LEN,
                                   prefill_chunk=4, paged=paged, page_size=8)
    outs = []
    for graphed in (True, False):
        eng = engine_lib.ServingEngine(cfg, params, config=ecfg,
                                       device=hopper)
        assert eng.capacity_report()["step_graphs"]
        ptrs = steps._ptrs(eng.caches)
        if not graphed:
            eng._decode = steps.make_decode_step(cfg)
            eng._prefill = steps.make_prefill_chunk_step(cfg)
        rng = np.random.default_rng(7)
        reqs = [engine_lib.Request(i, rng.integers(0, 512, n).astype(
            np.int32), max_new_tokens=5) for i, n in enumerate(
                (3, 9, 5, 6, 2))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert steps._ptrs(eng.caches) == ptrs
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("paged", [False, True])
def test_legacy_read_graphs_equal_eager(hopper, paged):
    """Under REPRO_FUSED_DECODE=0 the steps capture the legacy read: every
    graphed step bit-equal to the op-by-op step, no K3/K4 launch."""
    cfg = _cfg(4)
    with ulppack_attention.disabled():
        ulppack_attention.reset_counts()
        params, eager_c, graph_c, (dec, pre) = _pair(cfg, hopper, paged)
        eager = {"decode": steps.make_decode_step(cfg),
                 "prefill": steps.make_prefill_chunk_step(cfg)}
        graphed = {"decode": dec, "prefill": pre}
        extra = ()
        if paged:
            bt = np.zeros((B, MAX_LEN // PS), np.int32)
            bt[:2] = 1 + np.random.default_rng(1).permutation(
                P - 1)[:2 * bt.shape[1]].reshape(2, -1)
            extra = (bt,)
        for kind, tok, idx, vld in _schedule(np.random.default_rng(5)):
            args = ({"tokens": tok}, np.asarray(idx, np.int32),
                    np.asarray(vld, np.int32), *extra)
            want, _ = eager[kind](params, eager_c, *args)
            got, _ = graphed[kind](params, graph_c, *args)
            assert torch.equal(got, want), kind
        assert not any(ulppack_attention.kernel_launches.values())


def test_capture_failure_raises(hopper, monkeypatch):
    """A launcher that fails during capture makes building the pair raise;
    nothing falls back to the eager steps."""
    cfg = _cfg(4)
    real = cache_write.cache_write_cuda

    def failing(dest, leaves):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch refused under capture")
        return real(dest, leaves)

    monkeypatch.setattr(cache_write, "cache_write_cuda", failing)
    with pytest.raises(RuntimeError, match="refused under capture"):
        _pair(cfg, hopper, False)
    with pytest.raises(RuntimeError, match="refused under capture"):
        engine_lib.ServingEngine(cfg, lm.init_params(cfg, device=hopper),
                                 config=engine_lib.EngineConfig(
                                     max_batch=2, max_len=32,
                                     prefill_chunk=8), device=hopper)
