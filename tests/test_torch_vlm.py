"""The vision-language decoder (reduced ``qwen2-vl-2b``: 2 layers at d 64,
4 heads of 16 over 2 kv heads, M-RoPE sections (2, 3, 3), the vision
frontend's float projection 32 -> 64) against ``repro``, from the
reference's own init carried across the bridge, the reference run op by
op: ``lm.forward`` with an image prefix (``embeds``) and a real (t, h, w)
grid in ``positions3``, in modes 'none', 'qat' and 'packed'; the
fresh-cache prefill step over the prefix and the prompt, then decode
steps carrying ``positions3``; the engine's greedy tokens against the
reference engine's, which serves a VLM text-only with t = h = w, paged
and unpaged, on the port's static steps and on its op-by-op steps; the
bridge and the serving prep.

The grid is qwen2-vl's numbering: an image of 1 x 2 x 2 patches at (t, h,
w) = (0, i, j), then the text at t = h = w = max + 1 + k.  Tolerances:
f32 float and fake-quant forwards 1e-4, packed 1e-3 (the stablelm packed
forward's: the lattices are equal, norm, rope and softmax may differ in
the last bits).
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

ARCH = "qwen2-vl-2b"
MODES = ("none", "qat", "packed")
TOL = {"none": 1e-4, "qat": 1e-4, "packed": 1e-3}
B, GRID, S_TXT = 2, (1, 2, 2), 6
N_IMG = GRID[0] * GRID[1] * GRID[2]


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(kv_bits=16, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    q = dict(enabled=True, w_bits=2, a_bits=2, kv_bits=kv_bits)
    return (jconfigs.get_config(ARCH, reduced=True).replace(quant=JQ(**q),
                                                            **kw),
            tconfigs.get_config(ARCH, reduced=True).replace(quant=TQ(**q),
                                                            **kw))


@functools.lru_cache(maxsize=None)
def _jparams(kv_bits=16, dtype="float32", seed=2):
    jcfg, _ = _cfgs(kv_bits, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.device_get(jp)


def _params(mode, kv_bits=16):
    jcfg, tcfg = _cfgs(kv_bits)
    jp, host = _jparams(kv_bits)
    tp = bridge.from_repro(host, device="cpu")
    if mode == "packed":
        jp = jprepare.prepare_serving_params(jp, jcfg)
        tp = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def grid_positions3(b, grid, n_text, start_text=0):
    """[3, B, n_img + n_text] qwen2-vl ids: the image's patches at (t, h,
    w), the text after at t = h = w = max + 1 + k (k from
    ``start_text``)."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()])
    nxt = int(img.max()) + 1 + start_text
    txt = np.broadcast_to(np.arange(nxt, nxt + n_text), (3, n_text))
    ids = np.concatenate([img, txt], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(ids[:, None],
                                                (3, b, ids.shape[1])))


def _batch(seed, s_txt=S_TXT):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, s_txt)).astype(np.int32),
            "embeds": rng.normal(size=(B, N_IMG, 32)).astype(np.float32),
            "positions3": grid_positions3(B, GRID, s_txt)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_grid_positions3_is_qwen2_vl_numbering():
    p = grid_positions3(1, (1, 2, 2), 3)[:, 0]
    np.testing.assert_array_equal(p, [[0, 0, 0, 0, 2, 3, 4],
                                      [0, 0, 1, 1, 2, 3, 4],
                                      [0, 1, 0, 1, 2, 3, 4]])


@pytest.mark.parametrize("mode", MODES)
def test_forward_with_image_prefix_matches_reference(mode):
    jcfg, tcfg, jp, tp = _params(mode)
    batch = _batch(3)
    with jax.disable_jit():
        want, _, _ = jlm.forward(jp, jcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                                 quant_mode=mode)
    with torch.no_grad():
        got, _, _ = tlm.forward(tp, tcfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                                quant_mode=mode)
        text_only, _, _ = tlm.forward(
            tp, tcfg, {"tokens": torch.from_numpy(batch["tokens"])},
            quant_mode=mode)
    assert tuple(got.shape) == (B, N_IMG + S_TXT, tcfg.padded_vocab)
    _close(got.numpy(), want, TOL[mode])
    assert not np.allclose(got[:, N_IMG:].numpy(), text_only.numpy(),
                           atol=1e-2)


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_prefill_step_with_prefix_then_decode_matches_reference(kv_bits):
    """``make_prefill_step`` over the image prefix and the prompt (the
    cache holds rows 0 .. N_IMG + S_TXT - 1), then three packed decode
    steps at the next cache rows with their (t = h = w) ids carried in
    ``positions3``, against the reference's steps op by op."""
    jcfg, tcfg, jp, tp = _params("none", kv_bits)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    batch = _batch(4)
    dec = np.random.default_rng(5).integers(0, 512, (B, 3)).astype(np.int32)
    row0 = N_IMG + S_TXT
    ids = grid_positions3(B, GRID, S_TXT + 3)[:, :, row0:]     # [3, B, 3]
    with jax.disable_jit():
        jl, jc = jsteps.make_prefill_step(jcfg, 16)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        jdec = jsteps.make_decode_step(jcfg)
        jouts = []
        for t in range(3):
            out, jc = jdec(jpk, jc, {"tokens": jnp.asarray(dec[:, t:t + 1]),
                                     "positions3":
                                         jnp.asarray(ids[:, :, t:t + 1])},
                           jnp.full((B,), row0 + t, jnp.int32),
                           jnp.ones((B,), jnp.int32))
            jouts.append(out)
    tl, tc = tsteps.make_prefill_step(tcfg, 16)(tp, batch)
    _close(tl.numpy(), jl, TOL["qat"])
    tdec = tsteps.make_decode_step(tcfg)
    for t in range(3):
        out, tc = tdec(tpk, tc, {"tokens": dec[:, t:t + 1],
                                 "positions3": ids[:, :, t:t + 1]},
                       np.full(B, row0 + t, np.int32), np.ones(B, np.int32))
        _close(out.numpy(), jouts[t], TOL["packed"])
    # the ids differ from the cache rows: without them the steps part
    assert ids[0, 0, 0] != row0


def test_steps_derive_positions3_from_the_cache_rows():
    """Without ``positions3`` an M-RoPE config's step rotates every
    component at the cache position (the reference engine's t = h = w),
    bit-equal to passing that broadcast explicitly."""
    _, tcfg, _, tpk = _params("packed")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 512, (B, 4)).astype(np.int32)
    index = np.array([0, 3], np.int32)
    valid = np.array([4, 2], np.int32)
    pos = index[:, None] + np.arange(4, dtype=np.int32)
    runs = []
    for extra in ({}, {"positions3": np.broadcast_to(pos, (3, B, 4)).copy()}):
        caches = tlm.init_caches(tcfg, B, 16, dtype=torch.float32,
                                 device="cpu")
        out, _ = tsteps.make_prefill_chunk_step(tcfg)(
            tpk, caches, {"tokens": tokens, **extra}, index, valid)
        runs.append(out)
    assert torch.equal(runs[0], runs[1])


PROMPTS = (5, 9, 3)
NEW = 3


def _ecfg(module, paged):
    return module.EngineConfig(max_batch=2, max_len=24, prefill_chunk=4,
                               paged=paged, page_size=8)


def _serve(module, cfg, params, ecfg, eager_steps=False, **kw):
    eng = module.ServingEngine(cfg, params, config=ecfg, **kw)
    if eager_steps:                  # the op-by-op steps of launch/steps.py
        eng._decode = tsteps.make_decode_step(eng.cfg)
        eng._prefill = tsteps.make_prefill_chunk_step(eng.cfg)
    rng = np.random.default_rng(13)
    reqs = [module.Request(i, rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=NEW) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference_tokens(kv_bits, paged):
    jcfg, _ = _cfgs(kv_bits)
    with jax.disable_jit():
        return _serve(jengine, jcfg, _jparams(kv_bits)[0],
                      _ecfg(jengine, paged))


@pytest.mark.parametrize("eager_steps", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_bits", [16, 4])
def test_engine_tokens_equal_reference(kv_bits, paged, eager_steps):
    """Text-only serving with t = h = w: greedy tokens equal to the
    reference engine's, on the engine's static steps (derived ids) and on
    the op-by-op steps."""
    _, tcfg = _cfgs(kv_bits)
    got = _serve(tengine, tcfg, _params("none", kv_bits)[3],
                 _ecfg(tengine, paged), eager_steps=eager_steps,
                 device="cpu")
    assert all(len(o) == NEW for o in got)
    assert got == _reference_tokens(kv_bits, paged)


def test_params_bridge_and_serving_prep():
    """The port's init has the reference's tree (``frontend_proj`` a float
    dense without LSQ steps); a reference tree crosses the bridge and back
    leaf for leaf; the serving prep leaves ``frontend_proj`` and the tied
    embedding float and plans exactly the packed leaves."""
    jcfg, tcfg = _cfgs()
    _, host = _jparams()
    mine = bridge.to_numpy(tlm.init_params(tcfg, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(host)):
        assert a.shape == np.shape(b)
    assert set(host["frontend_proj"]) == {"kernel"}
    tp = bridge.from_repro(host, device="cpu")
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(tp)),
                    jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    assert torch.equal(pk["frontend_proj"]["kernel"],
                       tp["frontend_proj"]["kernel"])
    plans = tprepare.build_layer_plans(pk, tcfg, batch_rows=2)
    assert not any("frontend_proj" in k or "embed" in k for k in plans)
    assert len(plans) == tcfg.num_layers * 7
