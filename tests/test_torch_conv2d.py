"""K5 (packed conv2d) and K6 (integer conv2d): the port's plain versions
against the reference, bit for bit, over the layout family, both weight
stores and both paddings; the dense conv store and its expansion byte-equal;
the conv planners.

The reference's Pallas conv does not run on the installed JAX, so K5 is
held against ``repro``'s 'xla' packed conv and ``ref.conv2d_i32_ref``.  The
'xla' backend extracts once per run of k_tile lanes summed over *all*
kernel taps, which overflows the dot band once fh*fw*k_tile products
exceed what the band holds; it is therefore applied here one tap at a time
(a 1x1 kernel per call, exactly k_tile lanes per extraction, summed over
taps), and ``test_reference_xla_conv_extracts_past_k_tile`` shows the
whole-kernel call parting from the exact conv.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ulppack_conv2d as jconv  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.kernels import ops, plan as plan_lib  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ulppack_conv2d as tconv  # noqa: E402

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


def _specs():
    for w, a in ((1, 1), (2, 2), (3, 3)):
        yield from jpack.layout_family(w, a)
    yield jpack.PackSpec(4, 4, jnp.int32, 2, 16)


# (N, H, W, Cin, Fh, Fw, Co, padding, weight store)
GEOMS = [
    # Cp 16 > k_tile 14 at W2A2/int16; Co not a multiple of the block
    (1, 9, 10, 32, 7, 7, 5, "VALID", "lanes"),
    # even kernel; Cin 13 not a multiple of any word capacity (32/w_bits)
    (2, 7, 6, 13, 4, 4, 9, "SAME", "dense"),
    # odd x even kernel, SAME
    (1, 6, 5, 6, 3, 2, 3, "SAME", "lanes"),
]


def _case_id(v):
    if isinstance(v, jpack.PackSpec):
        return str(v)
    return "{3}ch-{4}x{5}-{7}-{8}".format(*v)


def _operands(spec, geom, seed):
    n, h, w, cin, fh, fw, co, padding, store = geom
    rng = np.random.default_rng(seed)
    q_x = rng.integers(0, spec.max_a + 1, (n, h, w, cin)).astype(np.int32)
    q_w = rng.integers(0, spec.max_w + 1, (fh, fw, cin, co)).astype(np.int32)
    xp = jpack.pack_activations(jnp.asarray(q_x), spec, axis=-1)
    if store == "dense":
        wp = jops.dense_store_conv_weights(jnp.asarray(q_w), spec.w_bits)
    else:
        wp = jpack.pack_weights(jnp.asarray(q_w), spec, axis=2)
    return q_x, q_w, xp, wp


def _xla_per_tap(xp, wp, spec, padding, store, k_full):
    """The reference's 'xla' packed conv applied tap by tap (1x1 kernels
    over shifted windows of the padded input), summed over taps."""
    fh, fw = wp.shape[:2]
    xp = jconv._maybe_pad_spatial(xp, fh, fw, padding)
    out_h, out_w = xp.shape[1] - fh + 1, xp.shape[2] - fw + 1
    total = 0
    for ih in range(fh):
        for iw in range(fw):
            total = total + jops.packed_conv2d(
                xp[:, ih:ih + out_h, iw:iw + out_w], wp[ih:ih + 1, iw:iw + 1],
                spec, padding="VALID", backend="xla", weight_store=store,
                k_full=k_full)
    return np.asarray(total)


@pytest.mark.parametrize("geom", GEOMS, ids=_case_id)
@pytest.mark.parametrize("js", list(_specs()), ids=_case_id)
def test_plain_packed_conv_bit_equal(js, geom):
    n, h, w, cin, fh, fw, co, padding, store = geom
    q_x, q_w, xp, wp = _operands(js, geom, seed=cin * 7 + fh + js.shift)
    ts = tpack.PackSpec.parse(str(js))
    k_full = cin if store == "dense" else None
    got = tconv.ulppack_conv2d_torch(
        torch.from_numpy(np.array(xp)), torch.from_numpy(np.array(wp)), ts,
        padding=padding, weight_store=store, k_full=k_full)
    assert got.dtype == torch.int32
    exact = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x), jnp.asarray(q_w),
                                           padding=padding))
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(
        got.numpy(), _xla_per_tap(xp, wp, js, padding, store, k_full))


def test_reference_xla_conv_extracts_past_k_tile():
    """At the full sparq-cnn shape (7x7, Cin 32, W2A2/int16xP2s8) the
    reference's whole-kernel 'xla' conv sums 49 * 14 packed products before
    one extraction and parts from the exact conv; the port's plain version
    (one extraction per tap and k_tile lanes) does not."""
    js = jpack.PackSpec(2, 2, jnp.int16)
    q_x, q_w, xp, wp = _operands(js, GEOMS[0], seed=0)
    exact = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x),
                                           jnp.asarray(q_w)))
    whole = np.asarray(jops.packed_conv2d(xp, wp, js, padding="VALID",
                                          backend="xla"))
    assert not np.array_equal(whole, exact)
    got = tconv.ulppack_conv2d_torch(
        torch.from_numpy(np.array(xp)), torch.from_numpy(np.array(wp)),
        tpack.PackSpec.parse(str(js)))
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("dtype,lo,hi", [
    (np.int8, -128, 128), (np.int16, -256, 256),
    # full int16 range over 7x7x32 taps: sums reach ~1.7e12 and wrap int32
    (np.int16, -32768, 32768)], ids=["int8", "int16-fig4", "int16-wrap"])
def test_plain_int_conv_bit_equal(dtype, lo, hi, padding):
    rng = np.random.default_rng(hi)
    q_x = rng.integers(lo, hi, (2, 9, 8, 32)).astype(dtype)
    q_w = rng.integers(lo, hi, (7, 7, 32, 6)).astype(dtype)
    want = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x), jnp.asarray(q_w),
                                          padding=padding))
    got = tconv.int_conv2d_torch(torch.from_numpy(q_x), torch.from_numpy(q_w),
                                 padding=padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = tref.conv2d_i32_ref(torch.from_numpy(q_x),
                                 torch.from_numpy(q_w), padding=padding)
    np.testing.assert_array_equal(oracle.numpy(), want)
    if hi == 32768 and padding == "VALID":
        # the exact sums leave int32, and the result is them mod 2^32
        x64, w64 = q_x.astype(np.int64), q_w.astype(np.int64)
        wide = sum(np.einsum("nhwc,co->nhwo", x64[:, i:i + 3, j:j + 2],
                             w64[i, j]) for i in range(7) for j in range(7))
        assert np.abs(wide).max() > 2**31
        np.testing.assert_array_equal(
            want, ((wide + 2**31) % 2**32 - 2**31).astype(np.int32))


@pytest.mark.parametrize("w_bits", [1, 2, 3, 4])
@pytest.mark.parametrize("cin", [5, 13, 32])
def test_dense_conv_store_and_expansion_byte_equal(w_bits, cin):
    rng = np.random.default_rng(w_bits * 100 + cin)
    q_w = rng.integers(0, 1 << w_bits, (3, 2, cin, 7)).astype(np.int32)
    want = np.asarray(jops.dense_store_conv_weights(jnp.asarray(q_w), w_bits))
    got = ops.dense_store_conv_weights(torch.from_numpy(q_w), w_bits)
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()
    for js in jpack.layout_family(w_bits, w_bits):
        ts = tpack.PackSpec.parse(str(js))
        lanes = tconv.expand_dense_taps(got, ts, cin)
        ref_lanes = np.asarray(jconv.expand_dense_taps(jnp.asarray(want), js,
                                                       cin))
        assert lanes.numpy().dtype == ref_lanes.dtype, js
        assert lanes.numpy().tobytes() == ref_lanes.tobytes(), js
        # and equal to the lattice packed straight into lanes
        direct = tpack.pack_weights(torch.from_numpy(q_w), ts, axis=2)
        assert torch.equal(lanes, direct), js


def test_entry_points_route_through_plans():
    """ops.packed_conv2d / ops.int_conv2d on CPU tensors plan the 'torch'
    backend and reach the plain versions, never a kernel; 'cuda' on a CPU
    tensor raises instead of falling back."""
    ts = tpack.PackSpec(2, 2)
    rng = np.random.default_rng(3)
    q_x = torch.from_numpy(rng.integers(0, 4, (1, 8, 8, 9)).astype(np.int32))
    q_w = torch.from_numpy(rng.integers(0, 4, (3, 3, 9, 4)).astype(np.int32))
    xp = tpack.pack_activations(q_x, ts)
    tconv.reset_counts()
    for store in ("lanes", "dense"):
        wp = (ops.dense_store_conv_weights(q_w, 2) if store == "dense"
              else tpack.pack_weights(q_w, ts, axis=2))
        got = ops.packed_conv2d(xp, wp, ts, padding="SAME",
                                weight_store=store, k_full=9)
        assert torch.equal(got, tref.conv2d_i32_ref(q_x, q_w, "SAME"))
    got = ops.int_conv2d(q_x.to(torch.int16), q_w.to(torch.int8))
    assert torch.equal(got, tref.conv2d_i32_ref(q_x, q_w))
    assert tconv.plain_calls == {"ulppack_conv2d": 2, "int_conv2d": 1}
    assert tconv.kernel_launches == {"ulppack_conv2d": 0, "int_conv2d": 0,
                                     "ulppack_conv2d_mma": 0,
                                     "int_conv2d_mma": 0}
    assert tconv.mma_launches == {"s32": 0, "affine": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.packed_conv2d(xp, tpack.pack_weights(q_w, ts, axis=2), ts,
                          backend="cuda")
    with pytest.raises(TypeError, match="int8 or int16"):
        ops.int_conv2d(q_x, q_w)


@pytest.mark.parametrize("x_shape,w_shape,padding,store,k_full", [
    ((8, 256, 256, 16), (7, 7, 16, 32), "SAME", "lanes", None),
    ((8, 256, 256, 16), (7, 7, 2, 64), "SAME", "dense", None),
    ((1, 256, 256, 16), (7, 7, 16, 32), "VALID", "lanes", None),
    ((2, 7, 6, 7), (4, 4, 1, 9), "SAME", "dense", 13),
])
def test_conv_plan_records_store_and_fits_hopper(x_shape, w_shape, padding,
                                                 store, k_full):
    """The plan records the store and k_full; int16xP2s8 plans the
    tensor-core K5 (tests/test_torch_ulppack_conv_mma.py checks its
    geometry), and the CUDA-core tile's geometry for the same shapes still
    fits Hopper.  A 9x9 kernel over 512 lattice channels plans the tensor
    cores in channel chunks, a 25x25 one fits no chunk and is refused; the
    CUDA-core tile (on no route) refuses kernels wider than its register
    window."""
    ts = tpack.PackSpec(2, 2)
    plan = plan_lib.plan_packed_conv2d(x_shape, w_shape, ts, padding=padding,
                                       weight_store=store, k_full=k_full)
    assert (plan.op, plan.backend, plan.spec) == ("packed_conv2d", "torch",
                                                  ts)
    assert plan.weight_store == store
    # as the reference: a 'dense' plan defaults k_full to cp * n_pack
    want_k = (k_full or x_shape[-1] * ts.n_pack) if store == "dense" \
        else None
    assert plan.k_full == want_k
    assert plan.threads == plan_lib.CONV_MMA_THREADS
    assert plan.smem_bytes <= plan_lib.CONV_MMA_SMEM_MAX
    assert plan.describe()["weight_store"] == store
    core = plan_lib.packed_conv2d_core_geometry(x_shape, w_shape,
                                                padding=padding)
    assert core["block_co"] in (8, 16, 32)
    assert core["threads"] == (core["block_h"] * plan_lib.CONV_GPR
                               * core["block_co"] // plan_lib.CONV_CPT) <= 256
    assert core["smem_bytes"] <= plan_lib.CONV_SMEM_MAX
    iplan = plan_lib.plan_int_conv2d(x_shape, w_shape, x_bytes=2, w_bytes=2,
                                     padding=padding)
    assert iplan.op == "int_conv2d" and iplan.threads <= 256
    assert plan.route == "tensor_cores"
    wide = plan_lib.plan_packed_conv2d((1, 9, 9, 256), (9, 9, 256, 8),
                                       tpack.PackSpec(2, 2, "int32", 2, 16))
    assert wide.route == "tensor_cores" and wide.chunks > 1
    with pytest.raises(ValueError, match="shared memory"):
        plan_lib.plan_packed_conv2d((1, 9, 9, 256), (25, 25, 256, 8),
                                    tpack.PackSpec(2, 2, "int32", 2, 16))
    with pytest.raises(ValueError, match="register window"):
        plan_lib.packed_conv2d_core_geometry((1, 9, 9, 4), (9, 9, 4, 8))


def test_conv_tile_constants_match_the_kernel_source():
    """The planner's copy of the conv tile's constants is the one in
    csrc/conv2d_tile.cuh (the launcher re-checks threads and shared memory
    on the card)."""
    import re
    from pathlib import Path

    src = (Path(plan_lib.__file__).parent.parent / "csrc"
           / "conv2d_tile.cuh").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert "constexpr int TW = PPT * GPR;" in src
    assert (c["PPT"], c["GPR"], c["CPT"], c["FW_MAX"], c["kMaxThreads"]) == (
        plan_lib.CONV_PPT, plan_lib.CONV_GPR, plan_lib.CONV_CPT,
        plan_lib.CONV_FW_MAX, plan_lib.CONV_MAX_THREADS)
    assert plan_lib.CONV_TILE_W == c["PPT"] * c["GPR"]
