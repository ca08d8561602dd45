"""K7 (the unpacked integer matmul, s8/s16 x s8/s16 -> s32) against the JAX
reference: the port's plain version equals ``repro``'s ``ops.int_matmul``
with the Pallas kernel (interpret mode) and with its 'xla' backend,
bit for bit, at shapes that are not multiples of the reference's
(128, 128, 512) blocks, and at int16 extremes whose s32 sums wrap."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_matmul as tmm  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(1, 7, 5), (5, 600, 130), (130, 600, 3), (130, 7, 129)]


def _operands(m, k, n, dt_a, dt_w, seed, extremes=False):
    rng = np.random.default_rng(seed)

    def draw(shape, dt):
        info = np.iinfo(dt)
        if extremes:                 # only the two ends of the range
            return rng.choice(np.array([info.min, info.max], dt), shape)
        return rng.integers(info.min, info.max, shape, dtype=dt,
                            endpoint=True)

    return draw((m, k), dt_a), draw((k, n), dt_w)


def _check(a, w, backends=("pallas", "xla")):
    got = tops.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    for be in backends:
        want = np.asarray(jops.int_matmul(jnp.asarray(a), jnp.asarray(w),
                                          backend=be))
        assert want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=be)
    return got


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dt_a,dt_w", [(np.int8, np.int8),
                                       (np.int16, np.int16)],
                         ids=["s8", "s16"])
def test_plain_int_matmul_bit_equal(shape, dt_a, dt_w):
    m, k, n = shape
    a, w = _operands(m, k, n, dt_a, dt_w, seed=m + k + n)
    _check(a, w)


@pytest.mark.parametrize("shape", [(5, 600, 130), (3, 4096, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int16_extremes_wrap_like_s32(shape):
    """Sums of +-2^30 products leave the int32 range: all three wrap the
    same way."""
    m, k, n = shape
    a, w = _operands(m, k, n, np.int16, np.int16, seed=k, extremes=True)
    got = _check(a, w, backends=("xla",) if k > 1000 else ("pallas", "xla"))
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2**31                 # the sums do wrap
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32))


def test_mixed_operands_and_leading_dims():
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (2, 3, 40), dtype=np.int8)
    w = rng.integers(-2**15, 2**15, (40, 6), dtype=np.int16)
    got = tops.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.shape == (2, 3, 6)
    want = np.asarray(jops.int_matmul(jnp.asarray(a), jnp.asarray(w),
                                      backend="xla"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_and_counts():
    """The planner picks the Hopper tile from M; the CPU path counts a
    plain call and no launch; wrong dtypes and shapes are refused."""
    assert tplan.plan_int_matmul(8, 4096, 4096).block_m == 16
    assert tplan.plan_int_matmul(64, 4096, 4096).block_m == 64
    for m, k, n in [(8, 4096, 4096), (64, 4096, 4096), (1, 7, 3),
                    (130, 600, 70), (8, 0, 4)]:
        p = tplan.plan_int_matmul(m, k, n)
        assert p.block_k % tplan.INT_MATMUL_BK == 0 and p.splits >= 1
        assert (p.splits - 1) * p.block_k < max(k, 1) <= max(
            p.splits * p.block_k, 1)
    p = tplan.plan_int_matmul(8, 4096, 4096, device="cpu")
    assert p.backend == "torch" and p.op == "int_matmul"
    tmm.reset_counts()
    a = torch.ones((2, 3), dtype=torch.int8)
    tops.int_matmul(a, torch.ones((3, 4), dtype=torch.int8))
    assert tmm.plain_calls == {"ulppack_matmul": 0, "int_matmul": 1}
    assert tmm.kernel_launches == {"ulppack_matmul": 0, "int_matmul": 0}
    with pytest.raises(TypeError, match="int8 / int16"):
        tops.int_matmul(a.to(torch.int32), torch.ones((3, 4),
                                                      dtype=torch.int8))
    with pytest.raises(ValueError, match="do not contract"):
        tmm.int_matmul_torch(a, torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        tplan.plan_int_matmul(8, 8, 8, backend="cuda", device="cpu")
