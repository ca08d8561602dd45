"""The port's ISA-level ``vmacsr`` model (``repro_torch.core.vmacsr``)
against ``repro.core.vmacsr``: the lane ops bit-equal on int8 and int16
lanes at every shift; on int32 lanes bit-equal to the reference run with
JAX's 64-bit mode on (a subprocess with ``JAX_ENABLE_X64=1``, so the flag
cannot leak into other tests); the reference's truncation in JAX's default
32-bit mode pinned as its behaviour (its int32 lanes widen to int64,
which x32 turns into int32, so the shifter sees the product mod 2^32);
and the instruction-count model equal over a grid of (K, k_tile,
n_pack)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import vmacsr as tv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = {"int8": (np.int8, torch.int8), "int16": (np.int16, torch.int16),
         "int32": (np.int32, torch.int32)}


def _lanes(name, n=257, seed=0):
    np_t = LANES[name][0]
    info = np.iinfo(np_t)
    rng = np.random.default_rng(seed)
    vals = rng.integers(info.min, info.max, size=(3, n), endpoint=True)
    vals[:, :4] = [[info.min, info.max, 0, -1]] * 3
    return [v.astype(np_t) for v in vals]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import vmacsr
    return jnp, vmacsr


@pytest.mark.parametrize("lane", ["int8", "int16"])
def test_lane_ops_bit_equal(ref, lane):
    jnp, rv = ref
    vd, a, b = _lanes(lane)
    bits = np.dtype(LANES[lane][0]).itemsize * 8
    for shift in range(2 * bits):
        got = tv.vmacsr(_t(vd), _t(a), _t(b), shift).numpy()
        want = np.asarray(rv.vmacsr(jnp.asarray(vd), jnp.asarray(a),
                                    jnp.asarray(b), shift))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"shift {shift}")
    for shift in range(bits):
        np.testing.assert_array_equal(
            tv.vsrl(_t(a), shift).numpy(),
            np.asarray(rv.vsrl(jnp.asarray(a), shift)))
    np.testing.assert_array_equal(
        tv.vmacc(_t(vd), _t(a), _t(b)).numpy(),
        np.asarray(rv.vmacc(jnp.asarray(vd), jnp.asarray(a),
                            jnp.asarray(b))))
    np.testing.assert_array_equal(
        tv.vadd(_t(a), _t(b)).numpy(),
        np.asarray(rv.vadd(jnp.asarray(a), jnp.asarray(b))))
    for imm in (0, 1, 0x0F, 0x55, -1):
        np.testing.assert_array_equal(
            tv.vand(_t(a), imm).numpy(),
            np.asarray(rv.vand(jnp.asarray(a), imm)))


X64_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    assert jax.config.jax_enable_x64
    from repro.core import vmacsr as rv
    vd, a, b = (np.load(sys.argv[1])[k] for k in ("vd", "a", "b"))
    out = {}
    for s in range(64):
        out[f"mac{s}"] = np.asarray(rv.vmacsr(jnp.asarray(vd),
                                              jnp.asarray(a),
                                              jnp.asarray(b), s))
    for s in range(32):
        out[f"srl{s}"] = np.asarray(rv.vsrl(jnp.asarray(a), s))
    out["macc"] = np.asarray(rv.vmacc(jnp.asarray(vd), jnp.asarray(a),
                                      jnp.asarray(b)))
    out["add"] = np.asarray(rv.vadd(jnp.asarray(a), jnp.asarray(b)))
    np.savez(sys.argv[2], **out)
    print("X64_OK")
""")


def test_int32_lanes_bit_equal_with_x64(ref, tmp_path):
    """With JAX's 64-bit mode the reference widens an int32 lane's product
    to int64 as its docstring and the ISA say; the port does so always."""
    vd, a, b = _lanes("int32")
    np.savez(tmp_path / "in.npz", vd=vd, a=a, b=b)
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "JAX_ENABLE_X64": "1",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", X64_SCRIPT,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert "X64_OK" in r.stdout, (r.stdout[-1500:], r.stderr[-1500:])
    want = np.load(tmp_path / "out.npz")
    for s in range(64):
        got = tv.vmacsr(_t(vd), _t(a), _t(b), s).numpy()
        np.testing.assert_array_equal(got, want[f"mac{s}"].astype(np.int32),
                                      err_msg=f"shift {s}")
        assert want[f"mac{s}"].dtype == np.int32
    for s in range(32):
        np.testing.assert_array_equal(tv.vsrl(_t(a), s).numpy(),
                                      want[f"srl{s}"])
    np.testing.assert_array_equal(tv.vmacc(_t(vd), _t(a), _t(b)).numpy(),
                                  want["macc"])
    np.testing.assert_array_equal(tv.vadd(_t(a), _t(b)).numpy(),
                                  want["add"])


def test_reference_x32_truncates_an_int32_lane_product(ref):
    """JAX's default 32-bit mode turns the reference's int64 product into
    int32, so its shifter sees (a*b) mod 2^32: 128 where the ISA gives
    ((2^20+3)(2^20+5) >> 16) mod 2^32 = 16,777,344 (the port's answer)."""
    jnp, rv = ref
    import jax
    if jax.config.jax_enable_x64:
        pytest.skip("this process runs JAX with x64 on")
    a, b = 2 ** 20 + 3, 2 ** 20 + 5
    z = np.zeros(1, np.int32)
    with pytest.warns(UserWarning):
        got_ref = rv.vmacsr(jnp.asarray(z), jnp.asarray([a], jnp.int32),
                            jnp.asarray([b], jnp.int32), 16)
    assert int(np.asarray(got_ref)[0]) == 128
    got = tv.vmacsr(_t(z), torch.tensor([a], dtype=torch.int32),
                    torch.tensor([b], dtype=torch.int32), 16)
    assert int(got[0]) == ((a * b) >> 16) % 2 ** 32 == 16_777_344
    # int8 and int16 lanes widen within 32 bits and are unaffected
    assert int(tv.vmacsr(torch.zeros(1, dtype=torch.int16),
                         torch.tensor([-32768], dtype=torch.int16),
                         torch.tensor([-32768], dtype=torch.int16),
                         16)[0]) == int(np.asarray(rv.vmacsr(
                             jnp.zeros(1, jnp.int16),
                             jnp.asarray([-32768], jnp.int16),
                             jnp.asarray([-32768], jnp.int16), 16))[0])


def test_lane_dtype_refused():
    with pytest.raises(TypeError, match="int8, int16 or int32"):
        tv.vmacsr(torch.zeros(2, dtype=torch.int64),
                  torch.zeros(2, dtype=torch.int64),
                  torch.zeros(2, dtype=torch.int64), 1)


@pytest.mark.parametrize("n_pack", [2, 3, 4])
def test_instruction_counts_equal(ref, n_pack):
    _, rv = ref
    for k in (1, 2, 7, 27, 64, 288, 1568, 4096, 40_000):
        for k_tile in (0, 1, 2, 3, 8, 16, 21, 64):
            for name in ("native_ulppack_instruction_count",
                         "vmacsr_instruction_count"):
                got = getattr(tv, name)(k, k_tile, n_pack)
                want = getattr(rv, name)(k, k_tile, n_pack)
                assert (got.macs, got.shifts, got.masks, got.adds,
                        got.total) == (want.macs, want.shifts, want.masks,
                                       want.adds, want.total), \
                    (name, k, k_tile, n_pack)
        got, want = tv.int16_instruction_count(k), \
            rv.int16_instruction_count(k)
        assert (got.macs, got.total) == (want.macs, want.total)
