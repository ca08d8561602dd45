"""``repro_torch.models.mamba`` against ``repro.models.mamba`` at reduced
jamba-1.5-large-398b width (d 64, d_inner 128, d_state 16, dt_rank 4,
conv 4; ``x_proj`` 128 -> 36), from the reference's own init carried
across the bridge, in modes 'none', 'qat' and 'packed' (both packages
pack their own copy), with the reference run op by op.

Tolerances: f32 rtol / atol 1e-5 -- the same ops, with the conv's and the
readout's sums possibly in another order (a few f32 ulps); bf16 one bf16
ulp (2^-7).  The states are f32 in both and held within 1e-5.  Dead rows
and pad tokens leave a state bit-unchanged.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -7)}
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = ("float32", "bfloat16")
MODES = ("none", "qat", "packed")
B = 3


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin both packages' tuning caches empty, so that no cache file a
    tuning run left changes a packed layout here."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (jconfigs.get_config(ARCH, reduced=True).replace(**kw),
            tconfigs.get_config(ARCH, reduced=True).replace(**kw))


def _params(dtype, mode, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg,
                           dtype=getattr(jnp, dtype))
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    if mode == "packed":
        jp = jprepare.prepare_serving_params(jp, jcfg)
        tp = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _x(seed, s, d, dtype):
    x = np.random.default_rng(seed).standard_normal((B, s, d)) \
        .astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _state(cfg, seed):
    """A nonzero cached state (numpy) of the reference's layout."""
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in jmamba.init_mamba_cache(cfg, B).items()}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _run(dtype, mode, s, valid, seed=0, state_seed=5):
    jcfg, tcfg, jp, tp = _params(dtype, mode, seed)
    jx, tx = _x(seed + 1, s, jcfg.d_model, dtype)
    st = _state(jcfg, state_seed)
    jc = {k: jnp.asarray(v) for k, v in st.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    with jax.disable_jit():
        jy, jnew = jmamba.mamba_apply(
            jp, jcfg, jx, quant_mode=mode, cache=jc,
            cache_index=jnp.zeros((B,), jnp.int32),
            cache_valid=jnp.asarray(valid, jnp.int32))
    with torch.no_grad():
        ty, tnew = tmamba.mamba_apply(
            tp, tcfg, tx, quant_mode=mode, cache=tc,
            cache_index=torch.zeros(B, dtype=torch.int32),
            cache_valid=torch.tensor(valid, dtype=torch.int32))
    return st, jy, jnew, ty, tnew, tc


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_uncached_window(dtype, mode):
    """S 12 from a zero state, no cache."""
    jcfg, tcfg, jp, tp = _params(dtype, mode)
    jx, tx = _x(2, 12, jcfg.d_model, dtype)
    with jax.disable_jit():
        jy, jnew = jmamba.mamba_apply(jp, jcfg, jx, quant_mode=mode)
    with torch.no_grad():
        ty, tnew = tmamba.mamba_apply(tp, tcfg, tx, quant_mode=mode)
    assert jnew is None and tnew is None
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **TOL[dtype])


@pytest.mark.parametrize("s,valid", [(1, [1, 0, 1]), (4, [4, 1, 0])])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cached_window(dtype, mode, s, valid):
    """A decode token and a 4-token window from a nonzero state with
    ragged ``cache_valid`` (0 included): outputs, and the conv and ssm
    states written in place, against the reference's new cache."""
    st, jy, jnew, ty, tnew, tc = _run(dtype, mode, s, valid)
    assert tnew is tc
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **TOL[dtype])
    for name in ("conv", "ssm"):
        assert tc[name].dtype == torch.float32
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jnew[name]),
                                   **STATE_TOL)
    # the conv history is a shifted copy: exact
    np.testing.assert_array_equal(tc["conv"].numpy(),
                                  np.asarray(jnew["conv"]))


@pytest.mark.parametrize("s", [1, 4])
def test_dead_rows_leave_the_state_unchanged(s):
    """Rows with ``cache_valid`` 0 keep both states bit for bit."""
    st, _, _, _, _, tc = _run("bfloat16", "packed", s, [0, 0, 0])
    for name in ("conv", "ssm"):
        np.testing.assert_array_equal(tc[name].numpy(), st[name])


def test_pad_tokens_leave_the_state_unchanged():
    """Two 4-token windows with one valid token a row, the same first
    token and different pad tokens, leave the same state bit for bit."""
    _, tcfg, _, tp = _params("float32", "none", 3)
    st = _state(_cfgs("float32")[0], 5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 4, tcfg.d_model)).astype(np.float32)
    other = x.copy()
    other[:, 1:] = rng.standard_normal((B, 3, tcfg.d_model))
    caches = []
    for xs in (x, other):
        c = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        with torch.no_grad():
            tmamba.mamba_apply(tp, tcfg, torch.from_numpy(xs), cache=c,
                               cache_index=torch.zeros(B, dtype=torch.int32),
                               cache_valid=torch.ones(B, dtype=torch.int32))
        caches.append(c)
    assert not np.array_equal(caches[0]["ssm"].numpy(), st["ssm"])
    for name in ("conv", "ssm"):
        torch.testing.assert_close(caches[0][name], caches[1][name],
                                   rtol=0, atol=0)


def test_prefill_of_a_fresh_cache():
    """A cache without ``cache_index``: the window runs from the zero
    state and its final state lands in the cache, as the reference's."""
    jcfg, tcfg, jp, tp = _params("float32", "qat")
    jx, tx = _x(6, 5, jcfg.d_model, "float32")
    tc = tmamba.init_mamba_cache(tcfg, B)
    with jax.disable_jit():
        jy, jnew = jmamba.mamba_apply(jp, jcfg, jx, quant_mode="qat",
                                      cache=jmamba.init_mamba_cache(jcfg, B))
    with torch.no_grad():
        ty, _ = tmamba.mamba_apply(tp, tcfg, tx, quant_mode="qat", cache=tc)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL["float32"])
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jnew[name]),
                                   **STATE_TOL)


def test_softplus_above_its_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x, also past
    ``F.softplus``'s threshold of 20, where that one returns x."""
    x = np.array([-30.0, -1.0, 0.0, 3.5, 19.9, 20.0, 20.5, 25.0, 80.0],
                 np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tmamba.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_init_and_cache_layouts_equal_the_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.device_get(jmamba.mamba_init(jax.random.PRNGKey(0), jcfg,
                                          dtype=jnp.bfloat16))
    tp = tmamba.mamba_init(torch.Generator().manual_seed(0), tcfg,
                           dtype=torch.bfloat16)
    flat_j = {tuple(str(k) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert len(flat_j) == 15
    for path, leaf in flat_j.items():
        node = tp
        for key in path:
            node = node[key.strip("[]'")]
        assert tuple(node.shape) == np.shape(leaf), path
        assert str(node.dtype).split(".")[-1] == np.asarray(leaf).dtype.name
    # log(1 .. ds): torch's and XLA's log may differ in the last bit
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2e-7, atol=0)
    assert tuple(tp["x_proj"]["kernel"].shape) == (128, 36)
    jc = jmamba.init_mamba_cache(jcfg, 2)
    tc = tmamba.init_mamba_cache(tcfg, 2)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.float32
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
