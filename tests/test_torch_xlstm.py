"""``repro_torch.models.xlstm`` against ``repro.models.xlstm`` at reduced
xlstm-1.3b width (d 64, 4 heads: mLSTM inner 128 of 32-wide heads, sLSTM
heads of 16, its FFN 64 -> 170 and 85 -> 64), from the reference's own
init carried across the bridge, in modes 'none', 'qat' and 'packed'
(both packages pack their own copy), with the reference run op by op.

Tolerances: f32 rtol / atol 1e-5 -- the same ops, the contractions
possibly summed in another order (the mLSTM's three-operand
``bhs,bhsd,bhse->bhde`` is taken as (w_kv * k) then v, which over a window
of more than one token may differ from XLA's order in the last bits);
bf16 one bf16 ulp (2^-7).  The states are f32 in both and held within
1e-5.  Dead rows leave a state bit-unchanged, the fresh mLSTM state (m =
-1e30) included.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ARCH = "xlstm-1.3b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -7)}
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = ("float32", "bfloat16")
MODES = ("none", "qat", "packed")
KINDS = ("mlstm", "slstm")
B = 3

FNS = {"mlstm": (jxlstm.mlstm_init, jxlstm.mlstm_apply,
                 jxlstm.init_mlstm_cache, txlstm.mlstm_init,
                 txlstm.mlstm_apply, txlstm.init_mlstm_cache),
       "slstm": (jxlstm.slstm_init, jxlstm.slstm_apply,
                 jxlstm.init_slstm_cache, txlstm.slstm_init,
                 txlstm.slstm_apply, txlstm.init_slstm_cache)}


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


def _params(kind, dtype, mode, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    jp = FNS[kind][0](jax.random.PRNGKey(seed), jcfg,
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


def _state(kind, cfg, seed):
    """A nonzero cached state (numpy) of the reference's layout: m below
    0, the sLSTM normalizer positive."""
    rng = np.random.default_rng(seed)
    st = {k: (0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in FNS[kind][2](cfg, B).items()}
    st["m"] -= 1.0
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 1.0
    return st


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _run(kind, dtype, mode, s, valid, state):
    jcfg, tcfg, jp, tp = _params(kind, dtype, mode)
    jx, tx = _x(1, s, jcfg.d_model, dtype)
    jc = {k: jnp.asarray(v) for k, v in state.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    with jax.disable_jit():
        jy, jnew = FNS[kind][1](
            jp, jcfg, jx, quant_mode=mode, cache=jc,
            cache_index=jnp.zeros((B,), jnp.int32),
            cache_valid=jnp.asarray(valid, jnp.int32))
    with torch.no_grad():
        ty, tnew = FNS[kind][4](
            tp, tcfg, tx, quant_mode=mode, cache=tc,
            cache_index=torch.zeros(B, dtype=torch.int32),
            cache_valid=torch.tensor(valid, dtype=torch.int32))
    assert tnew is tc
    return jy, jnew, ty, tc


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,s", [("mlstm", 150), ("slstm", 12)])
def test_uncached_window(kind, s, dtype, mode):
    """From the fresh state, no cache: the mLSTM at S 150 runs two chunks
    of 128, the second padded (input gate -1e30, forget gate 1)."""
    jcfg, tcfg, jp, tp = _params(kind, dtype, mode)
    jx, tx = _x(2, s, jcfg.d_model, dtype)
    with jax.disable_jit():
        jy, jnew = FNS[kind][1](jp, jcfg, jx, quant_mode=mode)
    with torch.no_grad():
        ty, tnew = FNS[kind][4](tp, tcfg, tx, quant_mode=mode)
    assert jnew is None and tnew is None
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **TOL[dtype])


@pytest.mark.parametrize("s,valid", [(1, [1, 0, 1]), (4, [4, 1, 0])])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_cached_window(kind, dtype, mode, s, valid):
    """A decode token and a 4-token window from a nonzero state with
    ragged ``cache_valid`` (0 included): outputs, and the states written
    in place, against the reference's new cache; the dead row's state
    bit-unchanged."""
    state = _state(kind, _cfgs(dtype)[0], 5)
    jy, jnew, ty, tc = _run(kind, dtype, mode, s, valid, state)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **TOL[dtype])
    dead = valid.index(0)
    for name in jnew:
        assert tc[name].dtype == torch.float32
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jnew[name]),
                                   **STATE_TOL)
        np.testing.assert_array_equal(tc[name].numpy()[dead],
                                      state[name][dead])


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_fresh_state_with_every_row_dead(kind, s):
    """The fresh state (m = -1e30) through a window with every row dead:
    there w_kv = exp(0) = 1, and only the zeroed k / v keep C and n
    unchanged.  Every leaf bit-equal to the fresh one, as the
    reference's."""
    jcfg = _cfgs("bfloat16")[0]
    fresh = {k: np.asarray(v) for k, v in FNS[kind][2](jcfg, B).items()}
    _, jnew, _, tc = _run(kind, "bfloat16", "packed", s, [0, 0, 0], fresh)
    for name in fresh:
        np.testing.assert_array_equal(tc[name].numpy(), fresh[name])
        np.testing.assert_array_equal(np.asarray(jnew[name]), fresh[name])


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_of_a_fresh_cache(kind):
    """A cache without ``cache_index``: the window runs from the fresh
    state and its final state lands in the cache, as the reference's."""
    jcfg, tcfg, jp, tp = _params(kind, "float32", "qat")
    jx, tx = _x(6, 5, jcfg.d_model, "float32")
    tc = FNS[kind][5](tcfg, B)
    with jax.disable_jit():
        jy, jnew = FNS[kind][1](jp, jcfg, jx, quant_mode="qat",
                                cache=FNS[kind][2](jcfg, B))
    with torch.no_grad():
        ty, _ = FNS[kind][4](tp, tcfg, tx, quant_mode="qat", cache=tc)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL["float32"])
    for name in jnew:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jnew[name]),
                                   **STATE_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_init_and_cache_layouts_equal_the_reference(kind):
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.device_get(FNS[kind][0](jax.random.PRNGKey(0), jcfg,
                                     dtype=jnp.bfloat16))
    tp = FNS[kind][3](torch.Generator().manual_seed(0), tcfg,
                      dtype=torch.bfloat16)
    flat_j = {tuple(str(k) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert len(flat_j) == {"mlstm": 18, "slstm": 10}[kind]
    for path, leaf in flat_j.items():
        node = tp
        for key in path:
            node = node[key.strip("[]'")]
        assert tuple(node.shape) == np.shape(leaf), path
        assert str(node.dtype).split(".")[-1] == np.asarray(leaf).dtype.name
    # the gate biases' fixed parts
    if kind == "mlstm":
        bias = tp["if_gate"]["bias"].float().numpy()
        np.testing.assert_array_equal(bias, np.asarray(
            jp["if_gate"]["bias"], np.float32))
    else:
        bias = tp["w_gates"]["bias"].float().numpy()
        np.testing.assert_array_equal(bias, np.asarray(
            jp["w_gates"]["bias"], np.float32))
    jc = FNS[kind][2](jcfg, 2)
    tc = FNS[kind][5](tcfg, 2)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.float32
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_log_sigmoid_matches_the_reference():
    """-logaddexp(-x, 0); at x = 90 the result is subnormal, which XLA
    flushes to zero on the CPU (hence the absolute 1e-37)."""
    x = np.array([-80.0, -25.0, -3.0, 0.0, 2.5, 21.0, 90.0], np.float32)
    np.testing.assert_allclose(
        txlstm.log_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))), rtol=1e-7,
        atol=1e-37)
