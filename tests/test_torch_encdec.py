"""The encoder-decoder (reduced ``seamless-m4t-medium``: 2 encoder + 2
decoder layers at d 64, 4 heads of 16, the audio frontend's float
projection 32 -> 64) against ``repro`` at f32, from the reference's own
init carried across the bridge, the reference run op by op:
``lm.encode``, ``attention.precompute_cross_kv`` and ``lm.forward`` with
``enc_embeds`` in modes 'none', 'qat' and 'packed' (both packages pack
their own copy); decode over the cached cross K/V (the counterpart of
``tests/test_serve.py::test_encdec_decode_uses_cached_cross_kv``); the
fresh-cache prefill step with ``enc_embeds`` and decode steps after it;
the engine's greedy tokens against the reference engine's, which serves
an encoder-decoder decoder-only (``cross_kv`` stays None), paged and
unpaged, with prefix sharing off; the caches, their byte counts, the
bridge and the serving prep.

Tolerances: float and fake-quant paths 1e-4 (the same ops; the encoder's
non-causal softmax and the port's K3 read differ in the last f32 bits);
packed paths 1e-3, as the stablelm packed forward (the lattices are
equal, norm, rope and softmax may differ in the last bits); decode over
the cached cross K/V against the teacher-forced forward 2e-3, the
reference test's own bound.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import ulppack_attention  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
MODES = ("none", "qat", "packed")
TOL = {"none": 1e-4, "qat": 1e-4, "packed": 1e-3}
B, S_ENC, S_DEC = 2, 6, 5


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(kv_bits=16, enabled=True, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    q = dict(enabled=enabled, w_bits=2, a_bits=2, kv_bits=kv_bits)
    return (jconfigs.get_config(ARCH, reduced=True).replace(quant=JQ(**q),
                                                            **kw),
            tconfigs.get_config(ARCH, reduced=True).replace(quant=TQ(**q),
                                                            **kw))


@functools.lru_cache(maxsize=None)
def _jparams(kv_bits=16, enabled=True, dtype="float32", seed=3):
    jcfg, _ = _cfgs(kv_bits, enabled, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.device_get(jp)


def _params(mode, kv_bits=16, enabled=True):
    jcfg, tcfg = _cfgs(kv_bits, enabled)
    jp, host = _jparams(kv_bits, enabled)
    tp = bridge.from_repro(host, device="cpu")
    if mode == "packed":
        jp = jprepare.prepare_serving_params(jp, jcfg)
        tp = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _inputs(seed=4, b=B, s_enc=S_ENC, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s_enc, 32)).astype(np.float32),
            rng.integers(0, 512, (b, s_dec)).astype(np.int32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_encode_matches_reference(mode):
    jcfg, tcfg, jp, tp = _params(mode)
    enc, _ = _inputs()
    with jax.disable_jit():
        want = jlm.encode(jp, jcfg, jnp.asarray(enc), quant_mode=mode)
    with torch.no_grad():
        got = tlm.encode(tp, tcfg, torch.from_numpy(enc), quant_mode=mode)
    assert tuple(got.shape) == (B, S_ENC, tcfg.d_model)
    _close(got.numpy(), want, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_precompute_cross_kv_matches_reference(mode):
    jcfg, tcfg, jp, tp = _params(mode)
    rng = np.random.default_rng(8)
    enc_out = rng.standard_normal((B, S_ENC, jcfg.d_model)).astype(
        np.float32)
    with jax.disable_jit():
        jk, jv = jattention.precompute_cross_kv(
            jp["layers"][1]["cross"], jcfg, jnp.asarray(enc_out),
            quant_mode=mode)
    with torch.no_grad():
        tk, tv = tattention.precompute_cross_kv(
            tp["layers"][1]["cross"], tcfg, torch.from_numpy(enc_out),
            quant_mode=mode)
    assert tk.dtype == torch.float32            # the compute dtype
    assert tuple(tk.shape) == (B, S_ENC, tcfg.num_kv_heads,
                               tcfg.resolved_head_dim)
    _close(tk.numpy(), jk, TOL[mode])
    _close(tv.numpy(), jv, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_forward_with_enc_embeds_matches_reference(mode):
    jcfg, tcfg, jp, tp = _params(mode)
    enc, tokens = _inputs(5)
    with jax.disable_jit():
        want, _, _ = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                            "enc_embeds": jnp.asarray(enc)},
                                 quant_mode=mode)
        no_enc, _, _ = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                   quant_mode=mode)
    with torch.no_grad():
        got, _, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                           "enc_embeds":
                                               torch.from_numpy(enc)},
                                quant_mode=mode)
        got_no, _, _ = tlm.forward(tp, tcfg,
                                   {"tokens": torch.from_numpy(tokens)},
                                   quant_mode=mode)
    _close(got.numpy(), want, TOL[mode])
    # without encoder states the cross sublayers are skipped, as there
    _close(got_no.numpy(), no_enc, TOL[mode])
    assert not np.allclose(got.numpy(), got_no.numpy(), atol=1e-2)


def _token_by_token(module, params, cfg, enc_out, tokens, caches, mode,
                    arr):
    logits = None
    for t in range(tokens.shape[1]):
        logits, _, caches = module.forward(
            params, cfg, {"tokens": arr(tokens[:, t:t + 1]),
                          "positions": arr(np.full((B, 1), t, np.int32))},
            caches=caches, cache_index=arr(np.int32(t)), quant_mode=mode,
            enc_out=enc_out if t == 0 else None)
    return logits[:, -1], caches


@pytest.mark.parametrize("mode", ["none", "packed"])
def test_decode_uses_cached_cross_kv(mode):
    """Encode once, then decode token by token over the cross K/V cached
    at the first call: the port equals its own teacher-forced forward
    (2e-3, the reference test's bound) and the reference's token-by-token
    run (TOL)."""
    jcfg, tcfg, jp, tp = _params(mode, enabled=mode == "packed")
    enc, tokens = _inputs(6)
    with jax.disable_jit():
        jenc = jlm.encode(jp, jcfg, jnp.asarray(enc), quant_mode=mode)
        want, jc = _token_by_token(
            jlm, jp, jcfg, jenc, tokens,
            jlm.init_caches(jcfg, B, 8, dtype=jnp.float32), mode,
            jnp.asarray)
    with torch.no_grad():
        full, _, _ = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                            "enc_embeds":
                                                torch.from_numpy(enc)},
                                 quant_mode=mode)
        tenc = tlm.encode(tp, tcfg, torch.from_numpy(enc), quant_mode=mode)
        caches = tlm.init_caches(tcfg, B, 8, dtype=torch.float32,
                                 device="cpu")
        assert all(c["cross_kv"] is None for c in caches)
        got, caches = _token_by_token(tlm, tp, tcfg, tenc, tokens, caches,
                                      mode, torch.as_tensor)
    for li, c in enumerate(caches):
        k, v = c["cross_kv"]
        assert tuple(k.shape) == (B, S_ENC, tcfg.num_kv_heads,
                                  tcfg.resolved_head_dim)
        _close(k.numpy(), jc[li]["cross_kv"][0], TOL[mode])
    _close(got.numpy(), full[:, -1].numpy(), max(2e-3, TOL[mode]))
    _close(got.numpy(), want, TOL[mode])


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_prefill_step_then_decode_matches_reference(kv_bits):
    """``make_prefill_step`` with ``enc_embeds`` (the fake-quant forward
    fills the self-attention caches and stores the cross K/V), then three
    packed decode steps over both caches, against the reference's steps
    op by op."""
    jcfg, tcfg, jp, tp = _params("none", kv_bits)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    enc, tokens = _inputs(7, s_dec=8)
    dec = np.random.default_rng(9).integers(0, 512, (B, 3)).astype(np.int32)
    batch = {"tokens": tokens, "enc_embeds": enc}
    with jax.disable_jit():
        jl, jc = jsteps.make_prefill_step(jcfg, 16)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        jdec = jsteps.make_decode_step(jcfg)
        jouts = []
        for t in range(3):
            out, jc = jdec(jpk, jc, {"tokens": jnp.asarray(dec[:, t:t + 1])},
                           jnp.full((B,), 8 + t, jnp.int32),
                           jnp.ones((B,), jnp.int32))
            jouts.append(out)
    tl, tc = tsteps.make_prefill_step(tcfg, 16)(tp, batch)
    _close(tl.numpy(), jl, TOL["qat"])
    assert all(c["cross_kv"] is not None for c in tc)
    for c, j in zip(tc, jc):
        _close(c["cross_kv"][1].numpy(), j["cross_kv"][1], TOL["qat"])
    tdec = tsteps.make_decode_step(tcfg)
    for t in range(3):
        out, tc = tdec(tpk, tc, {"tokens": dec[:, t:t + 1]},
                       np.full(B, 8 + t, np.int32), np.ones(B, np.int32))
        _close(out.numpy(), jouts[t], TOL["packed"])


PROMPTS = (5, 9, 3)
NEW = 3


def _ecfg(module, paged):
    return module.EngineConfig(max_batch=2, max_len=24, prefill_chunk=4,
                               paged=paged, page_size=8)


def _serve(module, cfg, params, ecfg, **kw):
    eng = module.ServingEngine(cfg, params, config=ecfg, **kw)
    rng = np.random.default_rng(11)
    reqs = [module.Request(i, rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=NEW) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _reference_tokens(kv_bits, paged):
    jcfg, _ = _cfgs(kv_bits)
    with jax.disable_jit():
        out, eng = _serve(jengine, jcfg, _jparams(kv_bits)[0],
                          _ecfg(jengine, paged))
    assert all(c.get("cross_kv") is None for c in eng.caches)
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits", [16, 4])
def test_engine_tokens_equal_reference(kv_bits, paged):
    """The engine serves an encoder-decoder decoder-only, as the
    reference's does: greedy tokens equal; ``cross_kv`` stays None; a
    paged engine keeps prefix sharing off."""
    _, tcfg = _cfgs(kv_bits)
    got, eng = _serve(tengine, tcfg, _params("none", kv_bits)[3],
                      _ecfg(tengine, paged), device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference_tokens(kv_bits, paged)
    assert all(c["cross_kv"] is None for c in eng.caches)
    if paged:
        assert eng.capacity_report()["prefix_sharing"] is False


def test_caches_and_byte_counts_match_reference():
    for kv_bits in (16, 8, 4, 2):
        jcfg, tcfg = _cfgs(kv_bits)
        caches = tlm.init_caches(tcfg, 2, 16, device="cpu")
        assert len(caches) == tcfg.num_layers
        assert all(set(c) == {"attn", "cross_kv"} and c["cross_kv"] is None
                   for c in caches)
        assert tlm.cache_bytes(tcfg, 2, 16) == jlm.cache_bytes(jcfg, 2, 16)
        assert tlm.cache_page_bytes(tcfg, 8) == jlm.cache_page_bytes(jcfg, 8)


def test_params_bridge_and_serving_prep():
    """The port's init has the reference's tree; a reference tree crosses
    the bridge and back leaf for leaf; the serving prep packs the encoder's
    and the cross sublayers' projections, leaves ``frontend_proj`` float,
    and plans exactly the packed leaves."""
    jcfg, tcfg = _cfgs()
    jp, host = _jparams()
    tp = bridge.from_repro(host, device="cpu")
    mine = tlm.init_params(tcfg, device="cpu")
    assert jax.tree.structure(bridge.to_numpy(mine)) \
        == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(mine)),
                    jax.tree.leaves(host)):
        assert a.shape == np.shape(b)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(tp)),
                    jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    assert set(pk["frontend_proj"]) == {"kernel"}
    assert "w_packed" in pk["encoder"]["layers"][0]["attn"]["q"]
    assert "w_packed" in pk["layers"][0]["cross"]["o"]
    plans = tprepare.build_layer_plans(pk, tcfg, batch_rows=2)
    keys = {k.rsplit("/", 1)[0] for k in plans}
    assert "encoder/layers[1]/attn" in keys and "layers[0]/cross" in keys
    assert not any("frontend_proj" in k for k in plans)


def test_serving_reads_go_through_k3():
    """A packed cache-free forward reads the encoder's non-causal
    self-attention and the decoder's cross-attention through K3 (its
    plain version on the CPU), equal within 1e-5 to the chunked read
    under the kill-switch; a 'qat' forward takes the chunked read."""
    jcfg, tcfg, jp, tp = _params("packed")
    enc, tokens = _inputs(12)
    batch = {"tokens": torch.from_numpy(tokens),
             "enc_embeds": torch.from_numpy(enc)}
    ulppack_attention.reset_counts()
    with torch.no_grad():
        got, _, _ = tlm.forward(tp, tcfg, batch, quant_mode="packed")
        # 2 encoder layers, 2 decoder self + 2 cross reads
        assert ulppack_attention.plain_calls["attention_decode"] == 6
        with ulppack_attention.disabled():
            chunked, _, _ = tlm.forward(tp, tcfg, batch, quant_mode="packed")
        assert ulppack_attention.plain_calls["attention_decode"] == 6
        tlm.forward(_params("qat")[3], tcfg, batch, quant_mode="qat")
    assert ulppack_attention.plain_calls["attention_decode"] == 6
    _close(got.numpy(), chunked.numpy(), 1e-5)


def test_paged_state_round_trip_skips_cross_kv():
    """A paged encoder-decoder engine's drained state (pools, prefix
    index; ``cross_kv`` None) imports into a fresh engine, which then
    serves the reference's tokens."""
    _, tcfg = _cfgs(4)
    params = _params("none", 4)[3]
    _, eng = _serve(tengine, tcfg, params, _ecfg(tengine, True),
                    device="cpu")
    caches, meta = eng.export_paged_state()
    fresh = tengine.ServingEngine(tcfg, params, config=_ecfg(tengine, True),
                                  device="cpu")
    fresh.import_paged_state(caches, meta)
    for a, b in zip(fresh.caches, caches):
        assert a["cross_kv"] is None
        assert all(torch.equal(a["attn"][n], b["attn"][n]) for n in a["attn"])
    rng = np.random.default_rng(11)
    reqs = [tengine.Request(i, rng.integers(0, tcfg.vocab_size, n).astype(
        np.int32), max_new_tokens=NEW) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        fresh.submit(r)
    fresh.run_to_completion()
    assert [r.output for r in reqs] == _reference_tokens(4, True)


def test_windowed_encoder_is_refused():
    """K3 has no window and no config has a windowed encoder: a
    non-causal forward of a sliding-window config raises."""
    _, tcfg, _, tp = _params("none")
    wcfg = tcfg.replace(sliding_window=4)
    x = torch.zeros((1, 6, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="windowed encoder"):
        tattention.attention_apply(tp["encoder"]["layers"][0]["attn"], wcfg,
                                   x, positions=torch.arange(6)[None],
                                   causal=False)
