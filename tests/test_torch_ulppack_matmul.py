"""K2 (ULPPACK packed matmul) and the packed linear layer: the port's plain
version is bit-equal to the reference Pallas kernel (interpret mode) and to
both integer oracles for every feasible layout; ``quantized_linear``
matches the reference's within float tolerance with a bit-equal integer
core; packed Dense leaves are byte-equal."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ulppack_matmul as jmm  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.kernels import ulppack_matmul as tmm  # noqa: E402
from repro_torch.models import common  # noqa: E402

torch.set_num_threads(2)


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
def base_layouts():
    """Pin the reference's per-layer layout to the config's base spec: an
    empty tuning cache, so reports/autotune_cpu.json cannot pick another."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _cases():
    for w, a in ((2, 2), (4, 4)):
        for js in jpack.layout_family(w, a):
            yield pytest.param(js, id=str(js))


@pytest.mark.parametrize("js", list(_cases()))
def test_plain_matmul_bit_equal(js):
    ts = tpack.PackSpec.parse(str(js))
    rng = np.random.default_rng(js.shift * 3 + js.n_pack)
    m, k, n = 3, 61, 10                    # odd K: padded lanes and tiles
    qa = rng.integers(0, js.max_a + 1, (m, k)).astype(np.int32)
    qw = rng.integers(0, js.max_w + 1, (k, n)).astype(np.int32)
    ja = jpack.pack_activations(jnp.asarray(qa), js)
    jw = jpack.pack_weights(jnp.asarray(qw), js)
    want = np.asarray(jmm.ulppack_matmul(ja, jw, js, block_m=8, block_n=8,
                                         chunks=2, interpret=True))
    got = tmm.ulppack_matmul_torch(torch.from_numpy(np.array(ja)),
                                   torch.from_numpy(np.array(jw)), ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.packed_matmul_ref(
            jnp.asarray(qa), jnp.asarray(qw), js)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.matmul_i32_ref(jnp.asarray(qa),
                                                    jnp.asarray(qw))))
    np.testing.assert_array_equal(
        tref.matmul_i32_ref(torch.from_numpy(qa),
                            torch.from_numpy(qw)).numpy(), qa @ qw)
    np.testing.assert_array_equal(
        tref.packed_matmul_ref(torch.from_numpy(qa), torch.from_numpy(qw),
                               ts).numpy(), qa @ qw)


def test_plain_matmul_wraps_like_s32():
    """int32 lanes whose packed products overflow 32 bits: the extracted
    bands are still exact (products wrap mod 2^32 by design)."""
    ts = tpack.PackSpec(2, 2, "int32", 4, 8)
    rng = np.random.default_rng(0)
    qa = rng.integers(0, 4, (2, 64)).astype(np.int32)
    qw = rng.integers(0, 4, (64, 3)).astype(np.int32)
    a = tpack.pack_activations(torch.from_numpy(qa), ts)
    w = tpack.pack_weights(torch.from_numpy(qw), ts)
    assert int(a.abs().max()) * int(w.abs().max()) > 2**31
    np.testing.assert_array_equal(
        tmm.ulppack_matmul_torch(a, w, ts).numpy(), qa @ qw)


def _dense_pair(rng, k, n, qcfg_kw):
    """The same float Dense params in both packages (JAX init, bridged)."""
    jq = JQuantConfig(enabled=True, **qcfg_kw)
    jp = jcommon.dense_init(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                            k, n, quantized=True, qcfg=jq)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    return jq, jp, QuantConfig(enabled=True, **qcfg_kw), tp


@pytest.mark.parametrize("qkw", [dict(w_bits=2, a_bits=2),
                                 dict(w_bits=4, a_bits=4,
                                      lane_dtype="int32", pack_shift=16)],
                         ids=["W2A2-int16", "W4A4-int32"])
def test_pack_dense_params_byte_equal(base_layouts, qkw):
    rng = np.random.default_rng(1)
    jq, jp, tq, tp = _dense_pair(rng, 37, 24, qkw)
    want = jax.device_get(jcommon.pack_dense_params(jp, jq))
    got = common.pack_dense_params(tp, tq)
    assert set(got) == set(want)
    assert got["k_full"] == want["k_full"] == 37
    for key in ("w_packed", "col_sums", "w_zp", "a_zp", "w_scale",
                "a_scale"):
        w_arr = np.asarray(want[key])
        g_arr = got[key].numpy()
        assert g_arr.dtype == w_arr.dtype, key
        assert g_arr.tobytes() == w_arr.tobytes(), key


@pytest.mark.parametrize("rows", [1, 6])
def test_quantized_linear_matches_reference(base_layouts, rows):
    """f32 outputs agree to 1e-5 relative (same lattice, same affine
    correction; only f32 rounding order may differ), and the integer core
    is bit-equal."""
    rng = np.random.default_rng(rows)
    k, n = 40, 24
    jq, jp, tq, tp = _dense_pair(rng, k, n, dict(w_bits=2, a_bits=2))
    jpk = jcommon.pack_dense_params(jp, jq)
    tpk = common.pack_dense_params(tp, tq)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    js = jpack.PackSpec.from_config(jq)
    ts = tpack.PackSpec.from_config(tq)
    want = np.asarray(jops.quantized_linear(
        jnp.asarray(x), jpk["w_packed"], jpk["col_sums"], jpk["a_scale"],
        jpk["a_zp"], jpk["w_scale"], jpk["w_zp"], js, backend="xla"))
    got = ops.quantized_linear(
        torch.from_numpy(x), tpk["w_packed"], tpk["col_sums"],
        tpk["a_scale"], tpk["a_zp"], tpk["w_scale"], tpk["w_zp"], ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # integer core: quantize + pack + packed matmul, bit for bit
    ja, _ = jops.quantize_pack(jnp.asarray(x), jpk["a_scale"], jpk["a_zp"],
                               js, backend="xla")
    j_acc = np.asarray(jops.packed_matmul(ja, jpk["w_packed"], js,
                                          backend="xla"))
    ta, _ = ops.quantize_pack(torch.from_numpy(x), tpk["a_scale"],
                              tpk["a_zp"], ts)
    t_acc = ops.packed_matmul(ta, tpk["w_packed"], ts)
    np.testing.assert_array_equal(t_acc.numpy(), j_acc)
    # and against the float oracle of the whole layer
    oracle = tref.quantized_linear_ref(
        torch.from_numpy(x), tp["kernel"].float(), tpk["a_scale"],
        tpk["a_zp"], tpk["w_scale"], tpk["w_zp"], 2, 2)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5)
