"""``repro_torch.models.common.apply_mrope`` and ``layernorm_*`` against
``repro.models.common``, and M-RoPE inside ``attention_apply``.

M-RoPE is held at DISTINCT t, h and w ids (t = h = w would hide a wrong
section split) for the reduced qwen2-vl sections (2, 3, 3) at head_dim 16
and the full ones (16, 24, 24) at head_dim 128.  Tolerance: the port's
frequencies are computed in f64 and rounded once (the compiled
reference's value), the reference's in f32, so a frequency may differ by
an f32 ulp or two (2^-23 relative); at ids below 500 that moves an angle
by at most 500 * 2^-22 < 1.2e-4 rad, and an output by that times |x|
(< 5 here) -- atol 6e-4, rtol 0.  A wrong section split moves angles by
whole radians.  With t = h = w the port's ``apply_mrope`` is bit-equal
to its ``apply_rope``, which the serving path relies on.  LayerNorm: f32
within 1e-6, bf16 within one bf16 ulp (2^-7).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

torch.set_num_threads(2)

ROPE_TOL = dict(rtol=0, atol=6e-4)
SECTIONS = {16: (2, 3, 3), 128: (16, 24, 24)}


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _x(seed, hd, b=2, s=7, h=3):
    return np.random.default_rng(seed).standard_normal(
        (b, s, h, hd)).astype(np.float32)


def _distinct_positions3(seed, b=2, s=7, hi=500):
    """[3, B, S] ids with t, h and w different at every token."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(hi)[:3 * b * s].reshape(3, b, s)
    assert (p[0] != p[1]).all() and (p[1] != p[2]).all()
    return p.astype(np.int32)


@pytest.mark.parametrize("hd", sorted(SECTIONS))
def test_apply_mrope_matches_reference(hd):
    x = _x(hd, hd)
    p3 = _distinct_positions3(hd)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3),
                               SECTIONS[hd], 10000.0)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3),
                              SECTIONS[hd], 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)


@pytest.mark.parametrize("hd", sorted(SECTIONS))
def test_apply_mrope_splits_sections(hd):
    """Each channel band rotates by its own component: changing only the
    w ids leaves the t and h bands bit-unchanged and moves the w band."""
    x = torch.from_numpy(_x(hd + 1, hd))
    p3 = torch.from_numpy(_distinct_positions3(hd + 1))
    moved = p3.clone()
    moved[2] += 3
    a = tcommon.apply_mrope(x, p3, SECTIONS[hd])
    b = tcommon.apply_mrope(x, moved, SECTIONS[hd])
    half = hd // 2
    th = SECTIONS[hd][0] + SECTIONS[hd][1]
    for off in (0, half):                     # the x1 and the x2 halves
        assert torch.equal(a[..., off:off + th], b[..., off:off + th])
        assert not torch.equal(a[..., off + th:off + half],
                               b[..., off + th:off + half])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", sorted(SECTIONS))
def test_apply_mrope_equals_apply_rope_when_components_agree(hd, dtype):
    x = torch.from_numpy(_x(hd + 2, hd)).to(dtype)
    pos = torch.from_numpy(
        np.random.default_rng(hd).integers(0, 4096, (2, 7)).astype(np.int32))
    got = tcommon.apply_mrope(x, pos[None].expand(3, 2, 7), SECTIONS[hd])
    want = tcommon.apply_rope(x, pos)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_apply_mrope_refuses_sections_that_miss_half():
    x = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="sum to head_dim"):
        tcommon.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.int32),
                            (2, 3, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((2, 5, 48)) + 1.5).astype(np.float32)
    jp = {"scale": jnp.asarray(rng.standard_normal(48), jnp.float32),
          "bias": jnp.asarray(rng.standard_normal(48), jnp.float32)}
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    init = tcommon.layernorm_init(48)
    assert set(init) == set(jcommon.layernorm_init(48))
    assert torch.equal(init["scale"], torch.ones(48))
    assert torch.equal(init["bias"], torch.zeros(48))
    want = jcommon.layernorm_apply(jp, jnp.asarray(x, getattr(jnp, dtype)))
    got = tcommon.layernorm_apply(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _attn_setup(seed=0):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config("qwen2-vl-2b", reduced=True).replace(**kw)
    tcfg = tconfigs.get_config("qwen2-vl-2b", reduced=True).replace(**kw)
    jp = jattention.attention_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, bridge.from_repro(jax.device_get(jp),
                                             device="cpu")


@pytest.mark.parametrize("mode", ["none", "qat"])
def test_attention_rotates_by_positions3(mode):
    """A cache-free causal forward of reduced qwen2-vl attention at a real
    (t, h, w) grid: the mask reads ``positions``, the angles
    ``positions3`` (f32, within 1e-5 of the reference); without
    ``positions3`` the plain RoPE."""
    jcfg, tcfg, jp, tp = _attn_setup()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    p3 = _distinct_positions3(9, hi=64)
    with jax.disable_jit():
        want, _ = jattention.attention_apply(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
            quant_mode=mode, positions3=jnp.asarray(p3))
        plain, _ = jattention.attention_apply(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
            quant_mode=mode)
    with torch.no_grad():
        got, _ = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=pos, quant_mode=mode,
            positions3=torch.from_numpy(p3))
        got_plain, _ = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=pos, quant_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_plain.numpy(), np.asarray(plain),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(got.numpy(), got_plain.numpy(), atol=1e-3)


def test_cached_step_keeps_positions_for_rows_and_mask():
    """A decode window after an image prefix: the cache row and mask read
    ``positions`` (the row), the rotation ``positions3`` (ids that differ
    from it); the written cache and the output equal the reference's."""
    jcfg, tcfg, jp, tp = _attn_setup(1)
    rng = np.random.default_rng(6)
    b, size = 2, 16
    hist = rng.standard_normal((b, 6, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    idx = np.array([6, 6], np.int32)
    p3 = np.array([[[4], [4]], [[9], [2]], [[11], [3]]], np.int32)
    jc = jattention.init_kv_cache(jcfg, b, size, jnp.float32)
    tc = tattention.init_kv_cache(tcfg, b, size, torch.float32)
    hist_pos = np.broadcast_to(np.arange(6, dtype=np.int32), (b, 6)).copy()
    with jax.disable_jit():
        _, jc = jattention.attention_apply(
            jp, jcfg, jnp.asarray(hist), positions=jnp.asarray(hist_pos),
            cache=jc, cache_index=jnp.zeros(b, jnp.int32))
        want, jc = jattention.attention_apply(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(idx[:, None]),
            cache=jc, cache_index=jnp.asarray(idx),
            positions3=jnp.asarray(p3))
    with torch.no_grad():
        tattention.attention_apply(
            tp, tcfg, torch.from_numpy(hist), positions=hist_pos, cache=tc,
            cache_index=torch.zeros(b, dtype=torch.int32))
        got, _ = tattention.attention_apply(
            tp, tcfg, torch.from_numpy(x), positions=idx[:, None], cache=tc,
            cache_index=torch.from_numpy(idx),
            positions3=torch.from_numpy(p3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)
    assert not tc["k"][:, 7:].any()
