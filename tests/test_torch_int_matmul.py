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
    assert tplan.plan_int_matmul(8, 4096, 4096).block_m == 8
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


PLAN_CASES = [(8, 4096, 4096, 1, 1), (64, 4096, 4096, 1, 1),
              (64, 4096, 4096, 2, 2), (8, 4096, 4096, 1, 2),
              (1, 7, 3, 1, 1), (9, 600, 70, 2, 1), (17, 40000, 4097, 2, 2),
              (130, 600, 70, 1, 2), (8, 0, 4, 1, 1),
              (6400, 100000, 12800, 1, 1), (2, 1 << 20, 8, 2, 2)]


@pytest.mark.parametrize("m,k,n,ab,wb", PLAN_CASES,
                         ids=lambda v: str(v))
def test_plan_geometry(m, k, n, ab, wb):
    """The splits cover K with no empty split, no split is longer than
    32768 (its s32 MMA sums stay in range), the last wave of blocks is
    less than one N x M tile grid short unless every split is one stage,
    and the geometry is the kernel's own tile."""
    p = tplan.plan_int_matmul(m, k, n, a_bytes=ab, w_bytes=wb)
    bk = tplan.INT_MATMUL_BK
    assert (p.block_n, p.step_k, p.threads) == (
        tplan.INT_MATMUL_BN, bk, tplan.INT_MATMUL_THREADS)
    assert p.block_m in tplan.INT_MATMUL_BLOCK_MS
    assert p.block_m >= min(m, 64)
    assert p.block_k % bk == 0
    assert bk <= p.block_k <= tplan.INT_MATMUL_MAX_BLOCK_K
    assert p.splits == max(1, -(-k // p.block_k)) <= 65535
    assert (p.stages, p.smem_bytes) == tplan.int_matmul_smem_layout(
        p.block_m, ab, wb)
    # a deeper ring would not fit; at least 3 stages (one in flight)
    assert 3 <= p.stages <= tplan.INT_MATMUL_MAX_STAGES
    assert p.smem_bytes <= tplan.INT_MATMUL_SMEM_MAX
    if p.stages < tplan.INT_MATMUL_MAX_STAGES:
        assert p.smem_bytes + p.smem_bytes // p.stages \
            > tplan.INT_MATMUL_SMEM_MAX
    tiles = -(-n // p.block_n) * -(-m // p.block_m)
    blocks = tiles * p.splits
    steps = max(1, -(-k // bk))
    assert p.splits == steps or -(-blocks // 132) * 132 - blocks < tiles
    if (m, k, n) in ((8, 4096, 4096), (64, 4096, 4096)):
        assert p.splits == 4        # the fastest split on an H100 (PERF.md)
    with pytest.raises(TypeError, match="int8 / int16"):
        tplan.plan_int_matmul(m, k, n, a_bytes=4)


def test_int_matmul_constants_match_the_kernel_source():
    """The planner's copy of K7's tile is the one in csrc/mma_s8.cuh (the
    tile K7 shares with K2's tensor-core route) and csrc/int_matmul.cu
    (the launcher re-checks it, and the shared memory, on the card)."""
    import re
    from pathlib import Path

    csrc = Path(tplan.__file__).parent.parent / "csrc"
    src = (csrc / "mma_s8.cuh").read_text() \
        + (csrc / "int_matmul.cu").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (c["kBN"], c["kBK"], c["kMaxStages"], c["kSmemMax"],
            c["kThreads"], c["kMaxBlockK"]) == (
        tplan.INT_MATMUL_BN, tplan.INT_MATMUL_BK, tplan.INT_MATMUL_MAX_STAGES,
        tplan.INT_MATMUL_SMEM_MAX, tplan.INT_MATMUL_THREADS,
        tplan.INT_MATMUL_MAX_BLOCK_K)
    assert "constexpr int kPlaneRow = kBK + 16;" in src
    assert tplan.INT_MATMUL_PLANE_ROW == tplan.INT_MATMUL_BK + 16
    cases = tuple(int(v) for v in
                  re.findall(r"case (\d+): return launch_variant", src))
    assert cases == tplan.INT_MATMUL_BLOCK_MS
    # the largest split keeps the worst accumulator (lo x lo) in int32
    assert 255 * 255 * tplan.INT_MATMUL_MAX_BLOCK_K < 2**31
    assert 255 * 255 * (tplan.INT_MATMUL_MAX_BLOCK_K + 1024) >= 2**31


def _byte_planes(x):
    """K7's operand planes as (int64 values, weight shift): an int16 x is
    hi = x >> 8 (s8, weight 2^8) and lo = x & 0xFF (u8); int8 is itself."""
    v = x.to(torch.int64)
    if x.dtype == torch.int8:
        return [(v, 0)]
    return [(v >> 8, 8), (v & 0xFF, 0)]


def byte_plane_matmul(a, w, block_k):
    """Step 3 of K7's design in plain torch: per K run of ``block_k``, one
    s32 partial sum per (a plane, W plane) pair -- four for s16 x s16 --
    each held to the int32 range the MMA accumulator has, then combined in
    uint32 as sum << shift and added over the runs mod 2^32."""
    total = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64)
    for k0 in range(0, a.shape[1], block_k):
        for ap, sa in _byte_planes(a[:, k0:k0 + block_k]):
            for wp, sw in _byte_planes(w[k0:k0 + block_k]):
                part = ap @ wp
                assert -2**31 <= int(part.min()) and int(part.max()) < 2**31
                total = (total + ((part & 0xFFFFFFFF) << (sa + sw))) \
                    & 0xFFFFFFFF
    return torch.where(total >= 2**31, total - 2**32, total).to(torch.int32)


@pytest.mark.parametrize("dt_a,dt_w", [(np.int16, np.int16),
                                       (np.int8, np.int16),
                                       (np.int16, np.int8),
                                       (np.int8, np.int8)],
                         ids=["s16xs16", "s8xs16", "s16xs8", "s8xs8"])
@pytest.mark.parametrize("k", [600, 40000])
def test_byte_plane_algebra_equals_reference(dt_a, dt_w, k):
    """The byte-plane split, four s32 partial sums per K run of at most
    32768 and the uint32 combine equal ``repro``'s int_matmul ('xla') at
    the operands' extremes (and -1, whose low byte is 255), where the s16
    sums wrap; the runs are the planner's for this shape and the longest
    the kernel takes."""
    rng = np.random.default_rng(k)

    def draw(shape, dt):
        info = np.iinfo(dt)
        return rng.choice(np.array([info.min, info.max, -1], dt), shape)

    a, w = draw((3, k), dt_a), draw((k, 5), dt_w)
    want = np.asarray(jops.int_matmul(jnp.asarray(a), jnp.asarray(w),
                                      backend="xla"))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    plan = tplan.plan_int_matmul(3, k, 5, a_bytes=a.itemsize,
                                 w_bytes=w.itemsize)
    for block_k in (plan.block_k, tplan.INT_MATMUL_MAX_BLOCK_K):
        got = byte_plane_matmul(ta, tw, block_k)
        np.testing.assert_array_equal(got.numpy(), want)
    if a.itemsize == w.itemsize == 2 and k > 2**15:
        exact = a.astype(np.int64) @ w.astype(np.int64)
        assert np.abs(exact).max() > 2**31             # the sums do wrap
