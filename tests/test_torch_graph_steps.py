"""The port's compiled serving steps on the CPU: fixed-shape cache writes
and the static-buffer steps (``launch/steps.graphed_serving_steps``).

- Destination rows + the plain predicated write (``kernels/cache_write``)
  leave the cache bytes equal to the ``nonzero`` + ``index_put_`` write
  they replace (kept rows quantized alone) and to the reference's own
  drop-mode scatter (``_cache_write_ragged`` / ``_cache_write_paged``), at
  kv_bits 16/8/4/2, ragged and paged, with dead rows, decode riders,
  windows past the end and dead slots' all-zero block tables (page 0 left
  unchanged).  Exact: the same quantized bytes are stored.
- The static-buffer step, which the card captures as a CUDA graph and the
  CPU runs eagerly, gives logits and caches bit-equal to the op-by-op
  steps over prefill chunks and decodes, paged and unpaged; its buffers
  stay put and it refuses params / caches it was not built over.
- The graphs' split-K workspace grows only before it is frozen, and the
  counters of a captured graph's launches add up per replay.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import cache_write  # noqa: E402
from repro_torch.kernels import ulppack_attention  # noqa: E402
from repro_torch.kernels import ulppack_matmul  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

B, SQ, S, H, KVH = 3, 8, 24, 4, 2
PS, NP = 8, 3
P = B * NP + 3                      # page 0 and two more no table maps

# (offsets, valid counts) per window: a dead row, decode riders (valid 1
# in a chunk), ragged windows past max_len, one wholly past it
RAGGED = (([0, 0, 5], [8, 3, 0]), ([8, S - 2, 0], [1, 8, 1]),
          ([S + 1, 3, 20], [8, 0, 8]))
# paged: row 2's slot is dead (valid 0, all-zero table); row 0's last
# window runs past its table (positions clip to the last page)
PAGED = (([0, 0, 0], [8, 3, 0]), ([8, 3, 0], [1, 8, 0]),
         ([NP * PS - 3, 11, 0], [6, 8, 0]))


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def _cfgs(kv_bits):
    return (jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
                num_kv_heads=KVH, num_heads=H, quant=JQ(kv_bits=kv_bits)),
            tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
                num_kv_heads=KVH, num_heads=H, quant=TQ(kv_bits=kv_bits)))


def _nonzero_write(cache, k, v, keep, index, kv_bits):
    """The write the destination rows replace: the kept tokens gathered
    with ``nonzero``, quantized alone, put with ``index_put_``."""
    bi, ti = keep.nonzero(as_tuple=True)
    kk, vv = k[bi, ti], v[bi, ti]
    if "k_scale" in cache:
        qk, sk = tattention.kv_quantize(kk, kv_bits)
        qv, sv = tattention.kv_quantize(vv, kv_bits)
        vals = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        vals = {"k": kk, "v": vv}
    for name, val in vals.items():
        cache[name].index_put_(index(bi, ti), val.to(cache[name].dtype))


def _bytes(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.array(t).tobytes()


def _window_kv(rng, hd):
    return (rng.standard_normal((B, SQ, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, SQ, KVH, hd)).astype(np.float32))


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
def test_ragged_dest_rows_write_equals_nonzero_and_reference(kv_bits):
    jcfg, tcfg = _cfgs(kv_bits)
    jc = jattention.init_kv_cache(jcfg, B, S)
    got = tattention.init_kv_cache(tcfg, B, S)
    old = tattention.init_kv_cache(tcfg, B, S)
    rng = np.random.default_rng(kv_bits)
    offs = np.arange(SQ, dtype=np.int32)
    for idx, vlen in RAGGED:
        k, v = _window_kv(rng, jcfg.resolved_head_dim)
        idx, vlen = np.asarray(idx, np.int32), np.asarray(vlen, np.int32)
        jc = jattention._cache_write_ragged(
            jc, jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(idx[:, None] + offs[None, :]),
            jnp.asarray(offs[None, :] < vlen[:, None]), kv_bits)
        ti, tv = torch.from_numpy(idx), torch.from_numpy(vlen)
        dest = tattention.ragged_dest_rows(ti, tv, SQ, S)
        assert dest.shape == (B * SQ,) and dest.dtype == torch.int64
        tattention.cache_write(got, torch.from_numpy(k), torch.from_numpy(v),
                               dest, kv_bits)
        wpos = ti[:, None].long() + torch.arange(SQ)
        keep = (torch.arange(SQ) < tv[:, None]) & (wpos < S)
        _nonzero_write(old, torch.from_numpy(k), torch.from_numpy(v), keep,
                       lambda bi, ti_: (bi, wpos[bi, ti_]), kv_bits)
    for name in jc:
        assert _bytes(got[name]) == _bytes(old[name]) == _bytes(jc[name]), \
            name
    assert got["k"][1, S - 2:].any() and not got["k"][2, 1:20].any()


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
def test_paged_dest_rows_write_equals_nonzero_and_reference(kv_bits):
    jcfg, tcfg = _cfgs(kv_bits)
    jc = jattention.init_paged_kv_cache(jcfg, P, PS)
    got = tattention.init_paged_kv_cache(tcfg, P, PS)
    old = tattention.init_paged_kv_cache(tcfg, P, PS)
    rng = np.random.default_rng(10 + kv_bits)
    bt = np.zeros((B, NP), np.int32)          # row 2: a dead slot's table
    bt[:2] = (1 + rng.permutation(P - 3)[:2 * NP]).reshape(2, NP)
    offs = np.arange(SQ, dtype=np.int32)
    for idx, vlen in PAGED:
        k, v = _window_kv(rng, jcfg.resolved_head_dim)
        idx, vlen = np.asarray(idx, np.int32), np.asarray(vlen, np.int32)
        wpos = idx[:, None] + offs[None, :]
        pages = np.take_along_axis(bt, np.clip(wpos // PS, 0, NP - 1), 1)
        jc = jattention._cache_write_paged(
            jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
            jnp.asarray(wpos % PS), jnp.asarray(offs[None, :] < vlen[:, None]),
            kv_bits)
        ti, tv = torch.from_numpy(idx), torch.from_numpy(vlen)
        dest = tattention.paged_dest_rows(ti, tv, torch.from_numpy(bt), SQ, PS,
                                          P)
        assert dest.shape == (B * SQ,) and bool((dest[2 * SQ:] == -1).all())
        tattention.cache_write(got, torch.from_numpy(k), torch.from_numpy(v),
                               dest, kv_bits)
        tp, tw = torch.from_numpy(pages).long(), torch.from_numpy(wpos).long()
        keep = torch.arange(SQ) < tv[:, None]
        _nonzero_write(old, torch.from_numpy(k), torch.from_numpy(v), keep,
                       lambda bi, ti_: (tp[bi, ti_], tw[bi, ti_] % PS),
                       kv_bits)
    for name in jc:
        assert _bytes(got[name]) == _bytes(old[name]) == _bytes(jc[name]), \
            name
    assert not got["k"][0].any() and not got["k"][P - 2:].any()   # page 0
    assert got["k"][bt[0, NP - 1], :3].any()          # the clipped tail


def test_window_defaults_and_scalar_offset():
    # a scalar offset is the lockstep path: it stays 0-d, and a window
    # that overruns the cache starts at size - sq, where the reference's
    # dynamic_update_slice clamps it
    idx, vlen, dest, bt = tattention.window(5, None, None, 2, 4, (2, 8),
                                            "cpu")
    assert idx.dim() == 0 and int(idx) == 5
    assert vlen.tolist() == [4, 4] and bt is None
    assert dest.tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    _, _, dest, bt = tattention.window(
        [0, 3], [2, 0], np.array([[4, 2], [0, 0]]), 2, 3, (6, 2), "cpu")
    assert bt.dtype == torch.int32
    assert dest.tolist() == [8, 9, -1, -1, -1, -1]


def test_later_token_wins_a_shared_row():
    dest = torch.tensor([3, 1, 3, -1, 9, 1], dtype=torch.int64)
    assert cache_write.kept(dest, 8).tolist() == [False, False, True, False,
                                                  False, True]
    dst = torch.zeros((8, 2), dtype=torch.int32)
    src = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    cache_write.cache_write_torch(dest, [(dst, src)])
    want = torch.zeros_like(dst)
    for t, d in enumerate(dest.tolist()):     # a sequential scatter
        if 0 <= d < 8:
            want[d] = src[t]
    assert torch.equal(dst, want)


def test_cache_write_refusals():
    dst = torch.zeros((4, 2), dtype=torch.int32)
    src = torch.zeros((3, 2), dtype=torch.int32)
    dest = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        cache_write.cache_write(dest.int(), [(dst, src)])
    with pytest.raises(ValueError, match="does not fit"):
        cache_write.cache_write(dest, [(dst, src.short())])
    with pytest.raises(ValueError, match="does not fit"):
        cache_write.cache_write(dest[:2], [(dst, src)])
    with pytest.raises(ValueError, match="leaves"):
        cache_write.cache_write(dest, [(dst, src)] * 5)
    with pytest.raises(ValueError, match="CUDA"):
        cache_write.cache_write_cuda(dest, [(dst, src)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        cache_write.cache_write(dest, [(dst, src)], backend="cuda")


@pytest.mark.parametrize("row_bytes,ptrs,unit", [
    (1024, (256, 512), 16), (64, (256, 8), 8), (8, (0, 0), 8),
    (6, (256, 512), 2), (4, (2, 0), 2), (3, (0, 0), 1)])
def test_copy_unit(row_bytes, ptrs, unit):
    assert cache_write._unit(row_bytes, *ptrs) == unit


# ---------------------------------------------------------------------------
# The static-buffer steps
# ---------------------------------------------------------------------------

CHUNK, MAX_LEN = 8, 32


def _model(kv_bits=4):
    _, tcfg = _cfgs(kv_bits)
    tcfg = tcfg.replace(quant=TQ(enabled=True, w_bits=2, a_bits=2,
                                 kv_bits=kv_bits),
                        param_dtype="float32", compute_dtype="float32")
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    return tcfg, tprepare.prepare_serving_params(tp, tcfg, device="cpu")


def _caches(cfg, paged):
    if paged:
        return tlm.init_caches(cfg, B, MAX_LEN, page_size=PS, num_pages=P,
                               device="cpu")
    return tlm.init_caches(cfg, B, MAX_LEN, device="cpu")


def _schedule(paged):
    """(kind, tokens, index, valid) of a prefill chunk with a dead row, a
    second chunk with a decode rider, then decodes."""
    rng = np.random.default_rng(5)
    tok = lambda w: rng.integers(0, 512, (B, w)).astype(np.int32)  # noqa
    out = [("prefill", tok(CHUNK), [0, 0, 0], [CHUNK, 5, 0]),
           ("prefill", tok(CHUNK), [CHUNK, 5, 0], [1, CHUNK, 0])]
    pos = np.array([CHUNK + 1, 5 + CHUNK, 0])
    for _ in range(4):
        out.append(("decode", tok(1), pos.copy(), [1, 1, 0]))
        pos[:2] += 1
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_static_step_equals_eager_step(paged):
    cfg, params = _model()
    bt = None
    if paged:
        bt = np.zeros((B, MAX_LEN // PS), np.int32)
        bt[:2] = 1 + np.random.default_rng(1).permutation(
            P - 1)[:2 * bt.shape[1]].reshape(2, -1)
    eager_c, static_c = _caches(cfg, paged), _caches(cfg, paged)
    eager = {"decode": steps.make_decode_step(cfg),
             "prefill": steps.make_prefill_chunk_step(cfg)}
    dec, pre = steps.graphed_serving_steps(
        cfg, params, static_c, batch=B, prefill_chunk=CHUNK,
        block_table_width=None if bt is None else bt.shape[1])
    assert dec.graph is None and pre.graph is None      # the CPU: eager
    static = {"decode": dec, "prefill": pre}
    ptrs = {k: v.data_ptr() for s in (dec, pre) for k, v in s.buffers.items()}
    extra = () if bt is None else (bt,)
    for kind, tok, idx, vld in _schedule(paged):
        args = ({"tokens": tok}, np.asarray(idx, np.int32),
                np.asarray(vld, np.int32), *extra)
        want, _ = eager[kind](params, eager_c, *args)
        got, out = static[kind](params, static_c, *args)
        assert out is static_c
        assert torch.equal(got, want), kind
    for a, b in zip(eager_c, static_c):
        for name in a["attn"]:
            assert torch.equal(a["attn"][name], b["attn"][name]), name
    assert {k: v.data_ptr() for s in (dec, pre)
            for k, v in s.buffers.items()} == ptrs
    if paged:
        assert not static_c[0]["attn"]["k"][0].any()     # page 0 untouched


def test_static_step_refuses_other_params_caches_and_inputs():
    cfg, params = _model()
    caches = _caches(cfg, False)
    dec, pre = steps.graphed_serving_steps(cfg, params, caches, batch=B,
                                           prefill_chunk=CHUNK)
    tok = {"tokens": np.zeros((B, 1), np.int32)}
    idx, one = np.zeros(B, np.int32), np.ones(B, np.int32)
    dec(params, caches, tok, idx, one)
    dec(dict(params), list(caches), tok, idx, one)    # same tensors
    with pytest.raises(ValueError, match="caches are not"):
        dec(params, _caches(cfg, False), tok, idx, one)
    other = dict(params, embed={"table": params["embed"]["table"].clone()})
    with pytest.raises(ValueError, match="params are not"):
        dec(other, caches, tok, idx, one)
    with pytest.raises(ValueError, match="window"):
        pre(params, caches, tok, idx, one)
    with pytest.raises(ValueError, match="block_tables"):
        dec(params, caches, tok, idx, one, np.zeros((B, 4), np.int32))


def test_engine_builds_static_steps():
    """The engine serves through the static-buffer pair (eager on the CPU;
    on the card, captured graphs) and reports how long building it took."""
    cfg, _ = _model()
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = tengine.ServingEngine(cfg, tp, config=tengine.EngineConfig(
        max_batch=2, max_len=MAX_LEN, prefill_chunk=CHUNK), device="cpu")
    assert isinstance(eng._decode, steps.StaticStep)
    assert eng._prefill.buffers["tokens"].shape == (2, CHUNK)
    rep = eng.capacity_report()
    assert rep["step_graphs"] is False and rep["step_setup_s"] >= 0
    ulppack_attention.reset_counts()
    eng.submit(tengine.Request(0, np.arange(1, 12, dtype=np.int32),
                               max_new_tokens=3))
    assert len(eng.run_to_completion()[0].output) == 3
    assert ulppack_attention.plain_calls["attention_decode"] == \
        eng.metrics.steps * cfg.num_layers


def test_workspace_grows_until_frozen():
    ws = ulppack_matmul.Workspace(torch.device("cpu"))
    work, tickets = ws.get(100, 4)
    assert work.numel() == 100 and not tickets.any()
    assert ws.get(50, 2) == (work, tickets)          # big enough: kept
    work2, tickets2 = ws.get(60, 9)                  # more tiles: regrown
    assert work2 is work and tickets2.numel() == 9
    ws.frozen = True
    assert ws.get(100, 9) == (work2, tickets2)
    with pytest.raises(RuntimeError, match="frozen"):
        ws.get(101, 9)
    with pytest.raises(RuntimeError, match="frozen"):
        ws.get(10, 10)
    assert ws.work is work2 and ws.tickets is tickets2   # nothing moved


def test_workspace_scope_takes_every_launch():
    ws = ulppack_matmul.Workspace(torch.device("cpu"))
    with ulppack_matmul.workspace_scope(ws):
        work, _ = ulppack_matmul._workspace(torch.device("cpu"), 7, 30, 2)
        assert work is ws.work
        with pytest.raises(ValueError, match="scoped workspace"):
            ulppack_matmul._workspace(torch.device("meta"), 7, 30, 2)
    assert not ulppack_matmul._scope


def test_replay_counts_add_per_replay():
    """A captured graph's launches are counted once at capture and added
    again at each replay (``StaticStep.capture`` / ``__call__``)."""
    cache_write.reset_counts()
    ulppack_attention.reset_counts()
    before = steps._counts()
    cache_write.kernel_launches["cache_write"] += 2
    ulppack_attention.kernel_launches["attention_decode_paged"] += 2
    delta = steps._count_delta(before, steps._counts())
    steps._add_counts(delta, -1)                   # captured, not run
    assert steps._counts() == before
    for _ in range(3):
        steps._add_counts(delta)
    assert cache_write.kernel_launches["cache_write"] == 6
    assert ulppack_attention.kernel_launches["attention_decode_paged"] == 6
    assert ulppack_attention.kernel_launches["attention_decode"] == 0
    cache_write.reset_counts()
    ulppack_attention.reset_counts()
