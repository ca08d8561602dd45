"""The port's sparq-cnn packed inference against the JAX reference, at
``sparq_cnn.reduced_config()`` (channels (8, 8), 3x3, 16x16) and at a
7x7 / Cin 32 variant whose 16 lanes split into k_tile runs of 14 + 2: the
bridge, prepared leaves, per-layer plans, one conv layer's integer core and
output, and the whole forward.

The reference's 'xla' conv extracts once per k_tile lanes summed over all
49 taps, which is not exact at 7x7 / Cin 32 (tests/test_torch_conv2d.py);
for that variant the reference runs with its 'xla' conv applied one tap at
a time, so every extraction sees k_tile lanes, as its Pallas kernel does.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.kernels import ops as jops, plan as jplan  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ulppack_conv2d as jconv  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

CFGS = {
    "reduced": dict(),
    "7x7-cin32": dict(cnn_channels=(32, 16), cnn_kernel=7, cnn_input_hw=10),
}


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture(autouse=True)
def base_layouts():
    """Pin the reference's per-layer lane layout to the config's base spec
    (an empty tuning cache), the only layout the port uses."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _xla_per_tap(plan, x_packed, w_packed, padding):
    fh, fw = w_packed.shape[:2]
    xp = jconv._maybe_pad_spatial(x_packed, fh, fw, padding)
    out_h, out_w = xp.shape[1] - fh + 1, xp.shape[2] - fw + 1
    total = 0
    for ih in range(fh):
        for iw in range(fw):
            total = total + jops._packed_conv2d_xla(
                plan, xp[:, ih:ih + out_h, iw:iw + out_w],
                w_packed[ih:ih + 1, iw:iw + 1], "VALID")
    return total


@pytest.fixture(params=list(CFGS))
def setup(request, monkeypatch):
    """(jcfg, tcfg, JAX float params, the same params bridged to torch)."""
    name = request.param
    jcfg = jconfigs.get_config("sparq-cnn", reduced=True).replace(
        **CFGS[name])
    tcfg = tconfigs.get_config("sparq-cnn", reduced=True).replace(
        **CFGS[name])
    if name != "reduced":
        monkeypatch.setitem(jplan._BACKENDS, ("packed_conv2d", "xla"),
                            _xla_per_tap)
    jp = jcnn.init_params(jax.random.PRNGKey(len(name)), jcfg)
    return jcfg, tcfg, jp, bridge.from_repro(jax.device_get(jp),
                                             device="cpu")


def _image(cfg, n=2, seed=0):
    hw = cfg.cnn_input_hw
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


def _assert_bytes_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_bytes_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bytes_equal(g, w, f"{path}[{i}]")
    else:
        w = np.asarray(want)
        g = got.numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("store", ["float", "lanes", "dense"])
def test_bridge_carries_cnn_trees(setup, store):
    jcfg, _, jp, _ = setup
    tree = jp if store == "float" else jcnn.prepare_packed_params(
        jp, jcfg, weight_store=store)
    host = jax.device_get(tree)
    got = bridge.from_repro(host, device="cpu")
    _assert_bytes_equal(got, host)
    lay = got["layers"][0]
    scalars = ("alpha", "w_step") if store == "float" \
        else ("alpha", "w_scale", "w_zp")
    for k in scalars:
        assert lay[k].dim() == 0, k
    if store == "lanes":
        assert lay["w_packed"].dtype == torch.int16
    if store == "dense":
        assert lay["w_words"].dtype == torch.int32
        assert lay["w_zp"].dtype == torch.int32


@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_prepared_leaves_byte_equal(setup, store):
    jcfg, tcfg, jp, tp = setup
    want = jax.device_get(jcnn.prepare_packed_params(jp, jcfg,
                                                     weight_store=store))
    got = cnn.prepare_packed_params(tp, tcfg, weight_store=store)
    _assert_bytes_equal(got, want)
    one = cnn.conv_prepare(tp["layers"][-1], tcfg.quant, weight_store=store)
    _assert_bytes_equal(one, jax.device_get(jcnn.conv_prepare(
        jp["layers"][-1], jcfg.quant, weight_store=store)))


@pytest.mark.parametrize("store", ["float", "lanes", "dense"])
def test_layer_plans_record_spec_store_k_full(setup, store):
    jcfg, tcfg, jp, tp = setup
    if store != "float":
        jp = jcnn.prepare_packed_params(jp, jcfg, weight_store=store)
        tp = cnn.prepare_packed_params(tp, tcfg, weight_store=store)
    x_shape = _image(tcfg).shape
    want = jcnn.layer_plans(jp, jcfg, x_shape, backend="xla")
    got = cnn.layer_plans(tp, tcfg, x_shape)
    assert len(got) == len(want) == len(tcfg.cnn_channels)
    for g, w in zip(got, want):
        assert (str(g.spec), g.weight_store, g.k_full) == \
            (str(w.spec), w.weight_store, w.k_full)
        assert g.backend == "torch" and g.op == "packed_conv2d"


@pytest.mark.parametrize("store", ["unprepared", "lanes", "dense"])
def test_conv_apply_integer_core_and_output(setup, store):
    """One conv layer on the same float input: the activation lattice, the
    packed conv's accumulator and the patch sums are bit-equal to the
    reference's; the dequantized output agrees within rtol 1e-6 (the same
    f32 operations in the same order)."""
    jcfg, tcfg, jp, tp = setup
    jl, tl = jp["layers"][0], tp["layers"][0]
    if store != "unprepared":
        jl = jcnn.conv_prepare(jl, jcfg.quant, weight_store=store)
        tl = cnn.conv_prepare(tl, tcfg.quant, weight_store=store)
    cin = tcfg.cnn_channels[0]
    hw = tcfg.cnn_input_hw
    x = (np.random.default_rng(1).standard_normal((2, hw, hw, cin)) * 2
         ).astype(np.float32)
    core = cnn.conv_integer_core(tl, torch.from_numpy(x), tcfg.quant)
    # the reference's steps (cnn.py conv_apply), spelled out
    q = jcfg.quant
    alpha = jl["alpha"]
    a_scale = alpha / q.qmax_a
    xq = jquant.quantize_affine(jnp.clip(jnp.asarray(x), 0.0, alpha),
                                a_scale, 0, q.a_bits)
    kernel = jp["layers"][0]["kernel"]
    q_w = jquant.quantize_affine(kernel, jp["layers"][0]["w_step"],
                                 q.w_zero_point, q.w_bits)
    fh = kernel.shape[0]
    psum = jax.lax.conv_general_dilated(
        xq, jnp.ones((fh, fh, cin, 1), jnp.int32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(core["xq"].numpy(), np.asarray(xq))
    np.testing.assert_array_equal(core["psum"].numpy(), np.asarray(psum))
    np.testing.assert_array_equal(
        core["acc"].numpy(), np.asarray(jref.conv2d_i32_ref(xq, q_w, "SAME")))
    want = np.asarray(jcnn.conv_apply(jl, jnp.asarray(x), jcfg.quant,
                                      quant_mode="packed", backend="xla"))
    got = cnn.conv_apply(tl, torch.from_numpy(x), tcfg.quant,
                         quant_mode="packed")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _lattice_flips(jp, jcfg, tp, tcfg, x):
    """Per packed layer, the activation lattice values that differ between
    the two forwards, with the distance of x / a_scale from the rounding
    boundary there (what a one-ulp float difference upstream can flip)."""
    report = []
    jh = jax.nn.relu(jcnn.conv_apply(jp["stem"], jnp.asarray(x), jcfg.quant))
    th = torch.relu(cnn.conv_apply(tp["stem"], torch.from_numpy(x),
                                   tcfg.quant))
    for i, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"])):
        a_scale = np.asarray(jl["alpha"]) / jcfg.quant.qmax_a
        t = np.clip(np.asarray(jh), 0, np.asarray(jl["alpha"])) / a_scale
        jq = np.clip(np.round(t), 0, jcfg.quant.qmax_a)
        tq = cnn.conv_integer_core(tl, th, tcfg.quant)["xq"].numpy()
        bad = jq != tq
        if bad.any():
            margin = np.abs(np.abs(t - np.floor(t)) - 0.5)[bad]
            report.append(f"layer {i}: {int(bad.sum())} lattice flips, "
                          f"max distance from the rounding boundary "
                          f"{float(margin.max()):.3g}")
        jh = jax.nn.relu(jcnn.conv_apply(jl, jh, jcfg.quant,
                                         quant_mode="packed", backend="xla"))
        th = torch.relu(cnn.conv_apply(tl, th, tcfg.quant,
                                       quant_mode="packed"))
    return report


@pytest.mark.parametrize("mode,store", [("none", "float"),
                                        ("packed", "unprepared"),
                                        ("packed", "lanes"),
                                        ("packed", "dense")])
def test_forward_matches_reference(setup, mode, store):
    """Logits of the whole forward within 1e-5 absolute and relative of
    ``cnn.forward(..., backend="xla")``; on a mismatch the message lists
    any activation-lattice flips and their rounding margins."""
    jcfg, tcfg, jp, tp = setup
    if store in ("lanes", "dense"):
        jp = jcnn.prepare_packed_params(jp, jcfg, weight_store=store)
        tp = cnn.prepare_packed_params(tp, tcfg, weight_store=store)
    x = _image(tcfg)
    want = np.asarray(jcnn.forward(jp, jcfg, jnp.asarray(x), quant_mode=mode,
                                   backend="xla"))
    plans = cnn.layer_plans(tp, tcfg, x.shape) if store != "float" else None
    got = cnn.forward(tp, tcfg, torch.from_numpy(x), quant_mode=mode,
                      plans=plans)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if not np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-5):
        flips = _lattice_flips(jp, jcfg, tp, tcfg, x) if mode == "packed" \
            else []
        pytest.fail(f"logits differ by {np.abs(got.numpy() - want).max():.3g}"
                    f"; {flips or 'no lattice flips'}")


def test_unported_options_raise(setup):
    """The autotune paths are ported: on the CPU the layout sweep and the
    warm-tune run on the plain versions (the heuristic plan alone), and
    the plans come back from the tuning cache.  Unknown modes raise."""
    jcfg, tcfg, jp, tp = setup
    xs = (1, 8, 8, 3)
    packed = cnn.prepare_packed_params(tp, tcfg, x_shape=xs, autotune=True)
    plans = cnn.layer_plans(packed, tcfg, xs, autotune=True)
    assert len(plans) == len(tcfg.cnn_channels)
    assert {p.source for p in plans} == {"tuned"}
    assert [p.spec for p in plans] == [
        cnn.conv_layer_spec((1, 8, 8, c), (tcfg.cnn_kernel,) * 2 + (c, co),
                            tcfg.quant)
        for c, co in zip((tcfg.cnn_channels[0],) + tcfg.cnn_channels[:-1],
                         tcfg.cnn_channels)]
    with pytest.raises(ValueError, match="quant_mode"):
        cnn.conv_apply(tp["layers"][0], torch.zeros(1, 8, 8, 8), tcfg.quant,
                       quant_mode="int8")
