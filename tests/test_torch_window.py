"""The legacy KV read, sliding-window rings and the fused read's gate
against the JAX reference at reduced size (``models/attention.py``).

* ``ring_positions`` / ``ring_positions_batch`` equal the reference's
  ``_ring_positions`` / ``_ring_positions_batch``.
* Ring writes (ragged decode steps past the wrap, lockstep windows whose
  start is clamped) leave bytes equal to the reference's at kv 16/8/4/2,
  and each step's attention output is within ``ATTN_TOL`` of the
  reference's legacy read.
* The legacy read over a contiguous and a paged cache (the kill-switch
  ``REPRO_FUSED_DECODE=0``, one variable for both packages) is within
  ``ATTN_TOL`` of the reference's; where both reads apply, the port's
  fused and legacy reads agree within ``ATTN_TOL``.
* The fresh-cache prefill of a ring at sq 12, 16 and 20 over window 8
  (the reference's write-then-roll) is byte-equal.
* A scalar ``cache_index`` with two new tokens takes the reference's
  lockstep legacy read (the second token does not see itself).

``ATTN_TOL`` is 1e-4 absolute and relative: both sides compute in f32 from
the same stored bytes (bf16-rounded K/V at kv 16), so only summation
order differs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ulppack_attention as jua  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import ulppack_attention as tua  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)

ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
B, MAX_LEN, WINDOW = 3, 32, 8


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty: no cache file left by a
    tuning run can change a q-chunk, a plan or a layout here."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(kv_bits, window=WINDOW, name="mixtral-8x7b"):
    """Float projections (the cache layout is ``kv_bits``'), f32 compute."""
    kw = dict(param_dtype="float32", compute_dtype="float32",
              sliding_window=window)
    jc = jconfigs.get_config(name, reduced=True)
    tc = tconfigs.get_config(name, reduced=True)
    return (jc.replace(quant=JQ(enabled=False, kv_bits=kv_bits), **kw),
            tc.replace(quant=TQ(enabled=False, kv_bits=kv_bits), **kw))


def _attn_params(jcfg, seed):
    jp = jattention.attention_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_repro(jax.device_get(jp), device="cpu")


def _bytes(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def _same_cache(tc, jc):
    assert set(tc) == set(jc)
    for name in jc:
        assert _bytes(tc[name]) == _bytes(jc[name]), name


def _x(rng, cfg, b, s):
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# Ring positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("size", [8, 12])
def test_ring_positions_equal_reference(window, size):
    for idx in (0, 3, 7, 8, 11, 12, 19, 40):
        want = np.asarray(jattention._ring_positions(idx, size, window))
        got = tattention.ring_positions(torch.tensor(idx), size, window)
        np.testing.assert_array_equal(got.numpy(), want)
    last = np.array([-1, 0, 5, 7, 8, 13, 23, 100], np.int32)
    want = np.asarray(jattention._ring_positions_batch(
        jnp.asarray(last), size, window))
    got = tattention.ring_positions_batch(torch.from_numpy(last), size,
                                          window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_is_sized_as_the_ring():
    jcfg, tcfg = _cfgs(4)
    for max_len in (5, 8, 32):
        want = jattention.init_kv_cache(jcfg, 2, max_len)
        got = tattention.init_kv_cache(tcfg, 2, max_len)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
        assert tlm.cache_bytes(tcfg, 2, max_len) == jlm.cache_bytes(
            jcfg, 2, max_len)


# ---------------------------------------------------------------------------
# Ring writes and the legacy ring read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
def test_ring_decode_steps_match_reference(kv_bits):
    """Ragged one-token decode steps past the wrap (rows at different
    offsets, a dead row on some steps): every step's output within
    ATTN_TOL of the reference, and the ring's bytes equal after each."""
    jcfg, tcfg = _cfgs(kv_bits)
    jp, tp = _attn_params(jcfg, kv_bits)
    rng = np.random.default_rng(kv_bits)
    jcache = jattention.init_kv_cache(jcfg, B, MAX_LEN)
    tcache = tattention.init_kv_cache(tcfg, B, MAX_LEN)
    start = np.array([0, 3, 5], np.int32)
    for step in range(14):
        idx = start + step
        valid = np.array([1, 1, 0 if step % 5 == 4 else 1], np.int32)
        x = _x(rng, tcfg, B, 1)
        jout, jcache = jattention.attention_apply(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(idx[:, None]),
            cache=jcache, cache_index=jnp.asarray(idx),
            cache_valid=jnp.asarray(valid))
        tout, tcache = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x),
            positions=torch.from_numpy(idx[:, None]), cache=tcache,
            cache_index=torch.from_numpy(idx),
            cache_valid=torch.from_numpy(valid))
        live = valid > 0
        np.testing.assert_allclose(tout.numpy()[live],
                                   np.asarray(jout)[live], **ATTN_TOL)
        _same_cache(tcache, jcache)


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
@pytest.mark.parametrize("index", [3, 6, 13])
def test_lockstep_window_writes_match_reference(kv_bits, index):
    """A scalar index with a 3-token window: the ring slot ``index % 8``,
    the start clamped to size - sq where the window would overrun (6, 13),
    as ``dynamic_update_slice`` clamps it; the lockstep legacy read."""
    jcfg, tcfg = _cfgs(kv_bits)
    jp, tp = _attn_params(jcfg, 10 + kv_bits)
    rng = np.random.default_rng(index)
    jcache = jattention.init_kv_cache(jcfg, B, MAX_LEN)
    tcache = tattention.init_kv_cache(tcfg, B, MAX_LEN)
    x = _x(rng, tcfg, B, 3)
    pos = np.repeat(index + np.arange(3, dtype=np.int32)[None], B, 0)
    jout, jcache = jattention.attention_apply(
        jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos), cache=jcache,
        cache_index=index)
    tout, tcache = tattention.attention_apply(
        tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=tcache, cache_index=index)
    _same_cache(tcache, jcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN_TOL)


@pytest.mark.parametrize("kv_bits", [16, 4])
@pytest.mark.parametrize("sq", [12, 16, 20])
def test_prefill_roll_matches_reference(kv_bits, sq):
    """The fresh-cache prefill of a ring of 8 slots with sq > 8: the
    reference writes the last 8 tokens at slot 0 and rolls them by sq % 8;
    the port writes token j at slot j % 8.  Ring bytes equal, outputs
    (the windowed mask over the raw window) within ATTN_TOL."""
    jcfg, tcfg = _cfgs(kv_bits)
    jp, tp = _attn_params(jcfg, sq)
    rng = np.random.default_rng(sq)
    x = _x(rng, tcfg, 2, sq)
    pos = np.repeat(np.arange(sq, dtype=np.int32)[None], 2, 0)
    jcache = jattention.init_kv_cache(jcfg, 2, MAX_LEN)
    tcache = tattention.init_kv_cache(tcfg, 2, MAX_LEN)
    jout, jcache = jattention.attention_apply(
        jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos), cache=jcache)
    tout, tcache = tattention.attention_apply(
        tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=tcache)
    _same_cache(tcache, jcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN_TOL)


def test_windowed_cache_free_forward_matches_reference():
    """The cache-free serving forward of a windowed config takes the
    windowed mask over the raw window (K3 has no window)."""
    jcfg, tcfg = _cfgs(16)
    jp, tp = _attn_params(jcfg, 3)
    x = _x(np.random.default_rng(3), tcfg, 2, 20)
    pos = np.repeat(np.arange(20, dtype=np.int32)[None], 2, 0)
    jout, _ = jattention.attention_apply(jp, jcfg, jnp.asarray(x),
                                         positions=jnp.asarray(pos))
    with torch.no_grad():
        tout, _ = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN_TOL)


def test_ring_refusals():
    _, tcfg = _cfgs(4)
    tp = _attn_params(_cfgs(4)[0], 0)[1]
    cache = tattention.init_kv_cache(tcfg, B, MAX_LEN)
    x = torch.zeros((B, 2, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="token-by-token"):
        tattention.attention_apply(tp, tcfg, x, positions=torch.zeros(
            (B, 2), dtype=torch.int32), cache=cache,
            cache_index=torch.zeros(B, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="do not compose"):
        tattention.attention_apply(
            tp, tcfg, x[:, :1], positions=torch.zeros((B, 1),
                                                      dtype=torch.int32),
            cache=cache, cache_index=torch.zeros(B, dtype=torch.int32),
            block_tables=torch.zeros((B, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        tattention.lockstep_dest_rows(torch.tensor(0), B, 9, 8)


# ---------------------------------------------------------------------------
# The legacy read (kill-switch) over contiguous and paged caches
# ---------------------------------------------------------------------------

def test_kill_switch_is_the_reference_variable():
    assert tua.ENV_FLAG == jua.ENV_FLAG == "REPRO_FUSED_DECODE"
    assert tua.enabled() and jua.enabled()
    with tua.disabled():
        assert not tua.enabled() and not jua.enabled()
    assert tua.enabled() and jua.enabled()


def _decode_pair(kv_bits, seed, paged):
    """A ragged prefill-chunk window then a decode step, non-windowed:
    (reference outputs, port outputs) of the decode step."""
    jcfg, tcfg = _cfgs(kv_bits, window=0, name="stablelm-1.6b")
    jp, tp = _attn_params(jcfg, seed)
    rng = np.random.default_rng(seed)
    index = np.array([0, 4, 0], np.int32)
    valid = np.array([6, 3, 0], np.int32)
    kw_j, kw_t = {}, {}
    if paged:
        ps, npg = 8, 3
        bt = np.array([[4, 1, 7], [2, 8, 0], [0, 0, 0]], np.int32)
        jcache = jattention.init_paged_kv_cache(jcfg, 9, ps)
        tcache = tattention.init_paged_kv_cache(tcfg, 9, ps)
        kw_j["block_tables"] = jnp.asarray(bt)
        kw_t["block_tables"] = torch.from_numpy(bt)
        del npg
    else:
        jcache = jattention.init_kv_cache(jcfg, B, 24)
        tcache = tattention.init_kv_cache(tcfg, B, 24)
    outs = []
    for sq in (6, 1):
        x = _x(rng, tcfg, B, sq)
        pos = (index[:, None] + np.arange(sq)[None, :]).astype(np.int32)
        jout, jcache = jattention.attention_apply(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
            cache=jcache, cache_index=jnp.asarray(index),
            cache_valid=jnp.asarray(valid), **kw_j)
        tout, tcache = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
            cache=tcache, cache_index=torch.from_numpy(index),
            cache_valid=torch.from_numpy(valid), **kw_t)
        outs.append((np.asarray(jout), tout.numpy()))
        index = index + valid
        valid = np.array([1, 1, 0], np.int32)
    _same_cache(tcache, jcache)
    return outs


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_legacy_read_matches_reference(kv_bits, paged):
    """Under REPRO_FUSED_DECODE=0 both packages take the legacy read:
    gathered (paged) and dequantized per q-chunk, ring-position mask."""
    with tua.disabled():
        outs = _decode_pair(kv_bits, 20 + kv_bits, paged)
    for want, got in outs:
        np.testing.assert_allclose(got[:2], want[:2], **ATTN_TOL)


@pytest.mark.parametrize("kv_bits", [16, 4, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_fused_and_legacy_reads_agree(kv_bits, paged):
    """Where both reads apply (per-row offsets, no window), the port's
    fused read and its legacy read give the same attention."""
    fused = _decode_pair(kv_bits, 40 + kv_bits, paged)
    with tua.disabled():
        legacy = _decode_pair(kv_bits, 40 + kv_bits, paged)
    for (_, f), (_, lg) in zip(fused, legacy):
        np.testing.assert_allclose(f[:2], lg[:2], **ATTN_TOL)


def test_legacy_read_expands_the_cache_per_chunk(monkeypatch):
    """The legacy read dequantizes inside each q-chunk, never once for the
    whole call: with a 2-row chunk a 5-token lockstep window expands the
    stored cache three times."""
    jcfg, tcfg = _cfgs(4, window=0, name="stablelm-1.6b")
    _, tp = _attn_params(jcfg, 1)
    calls = []
    real = tattention.cache_read
    monkeypatch.setattr(tattention, "cache_read",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tautotune, "attention_chunk_for",
                        lambda *a, **k: 2)
    cache = tattention.init_kv_cache(tcfg, B, 16)
    x = torch.from_numpy(_x(np.random.default_rng(1), tcfg, B, 5))
    tattention.attention_apply(tp, tcfg, x, positions=torch.arange(
        5, dtype=torch.int32), cache=cache, cache_index=0)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# The scalar-index fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [0, 4])
def test_scalar_index_two_tokens_matches_reference(kv_bits):
    """Reduced stablelm at f32: 4 prompt tokens written lockstep at 0, then
    2 new tokens at scalar position 4 of a 16-slot cache.  The reference's
    lockstep path masks with ``_ring_positions(4, ...)``, so the second new
    token does not see itself; the port used to widen the scalar into a
    vector and take the fused read (row 1 off by 0.42)."""
    jc = jconfigs.get_config("stablelm-1.6b", reduced=True)
    tc = tconfigs.get_config("stablelm-1.6b", reduced=True)
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jc.replace(quant=jc.quant.replace(kv_bits=kv_bits), **kw)
    tcfg = tc.replace(quant=tc.quant.replace(kv_bits=kv_bits), **kw)
    jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = jlm.init_caches(jcfg, 2, 16)
    tcache = tlm.init_caches(tcfg, 2, 16, device="cpu")
    with jax.disable_jit():
        for lo, hi in ((0, 4), (4, 6)):
            pos = np.arange(lo, hi, dtype=np.int32)[None].repeat(2, 0)
            jl, _, jcache = jlm.forward(
                jp, jcfg, {"tokens": jnp.asarray(tok[:, lo:hi]),
                           "positions": jnp.asarray(pos)},
                caches=jcache, cache_index=lo)
            tl, _, tcache = tlm.forward(
                tp, tcfg, {"tokens": torch.from_numpy(tok[:, lo:hi]),
                           "positions": torch.from_numpy(pos)},
                caches=tcache, cache_index=lo)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The kill-switch through the engine
# ---------------------------------------------------------------------------

def test_engine_under_kill_switch_equals_reference():
    """Reduced stablelm W2A2 at kv 4, f32: with REPRO_FUSED_DECODE=0 both
    engines read every cache through the legacy path (the port's static
    steps, the reference op by op), and the greedy tokens are equal."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as tengine

    jc = jconfigs.get_config("stablelm-1.6b", reduced=True)
    tc = tconfigs.get_config("stablelm-1.6b", reduced=True)
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=4)
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg, tcfg = jc.replace(quant=JQ(**q), **kw), tc.replace(quant=TQ(**q),
                                                             **kw)
    jp = jlm.init_params(jax.random.PRNGKey(5), jcfg)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    ekw = dict(max_batch=3, max_len=40, prefill_chunk=8)

    def serve(module, cfg, params, **kw):
        eng = module.ServingEngine(cfg, params,
                                   config=module.EngineConfig(**ekw), **kw)
        rng = np.random.default_rng(11)
        reqs = [module.Request(i, rng.integers(0, cfg.vocab_size, n).astype(
            np.int32), max_new_tokens=5) for i, n in enumerate((6, 13, 9))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.output for r in reqs]

    with tua.disabled():
        got = serve(tengine, tcfg, tp, device="cpu")
        with jax.disable_jit():
            want = serve(jengine, jcfg, jp)
    assert got == want
