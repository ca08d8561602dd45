"""K6 on the int8 tensor cores (``csrc/int_conv2d_mma.cu``) from the CPU: the
planner's route by shape and operand width and its geometry (the Fig. 4
shape, sparq-cnn's widths, the shapes left to the CUDA-core tile), the
planner's constants against the kernel's source, a plain emulation of the
kernel's byte-plane arithmetic -- signed high and unsigned low planes,
three s32 sums held to the int32 range, the uint32 combine -- against
``repro``'s ``ref.conv2d_i32_ref`` (run through JAX) and the port's plain
K6, the dispatch by route with CPU stand-ins, and the CUDA wrapper's
refusals.  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py -k int_conv2d``).

The reference's Pallas ``int_conv2d`` fails on the installed JAX
(``pl.Unblocked``), so the oracle is ``ref.conv2d_i32_ref``."""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_conv2d as tconv  # noqa: E402

torch.set_num_threads(2)

I32 = 2**31
TYPES = {1: np.int8, 2: np.int16}


def _plan(x_shape, w_shape, xb, wb, padding="VALID"):
    return tplan.plan_int_conv2d(x_shape, w_shape, x_bytes=xb, w_bytes=wb,
                                 padding=padding)


# ---------------------------------------------------------------------------
# The route and the planner
# ---------------------------------------------------------------------------

#: (x_shape, w_shape, x_bytes, w_bytes, padding, route): the Fig. 4 shape
#: and sparq-cnn's widths (C 32, 7x7, Co 32 / 64) fit the tensor cores at
#: every width; C 64 at 7x7 fits with int8 activations only (int16 ones
#: take two 107 KB halo slots); C past 64 at 7x7 and a 1x1 conv over 2,048
#: int16 channels do not; a 9x9 kernel (past the CUDA-core tile's register
#: window) fits.
ROUTES = [
    ((1, 256, 256, 32), (7, 7, 32, 32), 2, 2, "VALID", "tensor_cores"),
    ((1, 256, 256, 32), (7, 7, 32, 32), 1, 1, "VALID", "tensor_cores"),
    ((8, 256, 256, 32), (7, 7, 32, 64), 2, 2, "SAME", "tensor_cores"),
    ((8, 256, 256, 32), (7, 7, 32, 32), 2, 1, "SAME", "tensor_cores"),
    ((1, 256, 256, 64), (7, 7, 64, 32), 1, 2, "VALID", "tensor_cores"),
    ((1, 256, 256, 64), (7, 7, 64, 32), 1, 1, "VALID", "tensor_cores"),
    ((1, 256, 256, 64), (7, 7, 64, 32), 2, 2, "VALID", "cuda_cores"),
    ((1, 256, 256, 64), (7, 7, 64, 32), 2, 1, "VALID", "cuda_cores"),
    ((1, 256, 256, 33), (7, 7, 33, 32), 2, 2, "VALID", "cuda_cores"),
    ((1, 64, 64, 65), (7, 7, 65, 32), 1, 1, "SAME", "cuda_cores"),
    ((1, 64, 64, 2048), (1, 1, 2048, 16), 2, 2, "SAME", "cuda_cores"),
    ((1, 64, 64, 128), (3, 3, 128, 16), 1, 1, "SAME", "tensor_cores"),
    ((2, 19, 23, 5), (9, 9, 5, 17), 2, 2, "SAME", "tensor_cores"),
]


@pytest.mark.parametrize("x_shape,w_shape,xb,wb,padding,route", ROUTES,
                         ids=lambda v: str(v))
def test_route_by_shape_and_width(x_shape, w_shape, xb, wb, padding, route):
    """The plan records the route the predicate picks; a tensor-core plan
    fits the shared memory, a CUDA-core plan is the tile's own geometry."""
    assert tplan.int_conv2d_on_tensor_cores(
        x_shape, w_shape, x_bytes=xb, w_bytes=wb, padding=padding) is (
            route == "tensor_cores")
    p = _plan(x_shape, w_shape, xb, wb, padding)
    assert (p.op, p.backend, p.route) == ("int_conv2d", "torch", route)
    assert (p.x_bytes, p.w_bytes) == (xb, wb)
    row = p.describe()
    assert row["route"] == route and row["x_bytes"] == xb
    if route == "tensor_cores":
        assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX == 232448
        return
    assert p.block_w is None
    core = tplan.int_conv2d_core_geometry(x_shape, w_shape, padding=padding)
    assert dataclasses.asdict(p) == dataclasses.asdict(
        dataclasses.replace(p, **core))
    assert core["smem_bytes"] <= tplan.CONV_SMEM_MAX


#: (block_h, block_w, block_co, block_c, blocks, smem_bytes) per (x_shape,
#: Co, x_bytes, w_bytes): Fig. 4 (250 x 250 VALID, 128 tiles in two waves
#: of 64 blocks a channel block), sparq-cnn's 32->32 / 32->64 layers at 8
#: images (1,024 tiles), a 16-column image (32 x 16 tiles), Co 8.
GEOMETRY = {
    ((1, 256, 256, 32), 32, 2, 2):
        (16, 32, 16, 64, 64, 16 * (49 * 64 + 16) + 2 * 22 * 38 * 64),
    ((1, 256, 256, 32), 32, 1, 2):
        (16, 32, 16, 32, 64, 16 * (49 * 64 + 16) + 2 * 22 * 38 * 32),
    ((8, 256, 256, 32), 32, 2, 2):
        (16, 32, 16, 64, 64, 16 * (49 * 64 + 16) + 2 * 22 * 38 * 64),
    ((8, 256, 256, 32), 64, 2, 2):
        (16, 32, 16, 64, 32, 16 * (49 * 64 + 16) + 2 * 22 * 38 * 64),
    ((2, 40, 16, 8), 8, 1, 1):
        (32, 16, 8, 32, 4, 8 * (49 * 32 + 16) + 2 * 38 * 22 * 32),
}


@pytest.mark.parametrize("key", list(GEOMETRY), ids=lambda v: str(v))
def test_tensor_core_geometry(key):
    """512-pixel tiles, block_co 16 (8 when Co <= 8), block_c = x_bytes *
    cpc staged bytes a halo pixel, the weight block and the halo ring
    within the 232,448 bytes a block may use, and the blocks of one wave
    per channel block, each walking an equal share of the tiles."""
    x_shape, co, xb, wb = key
    padding = "VALID" if x_shape[0] == 1 else "SAME"
    w_shape = (7, 7, x_shape[-1], co)
    p = _plan(x_shape, w_shape, xb, wb, padding)
    got = (p.block_h, p.block_w, p.block_co, p.block_c, p.blocks,
           p.smem_bytes)
    assert got == GEOMETRY[key]
    assert p.block_h * p.block_w == tplan.CONV_MMA_TILE_PIXELS
    assert (p.threads, p.stages) == (tplan.CONV_MMA_THREADS,
                                     tplan.CONV_MMA_STAGES)
    assert p.smem_bytes == tplan.int_conv_mma_smem_bytes(
        7, 7, p.block_h, p.block_w, p.block_co, x_shape[-1], xb, wb)
    n, h, w, _ = x_shape
    out_h = h if padding == "SAME" else h - 6
    out_w = w if padding == "SAME" else w - 6
    tiles = n * -(-out_h // p.block_h) * -(-out_w // p.block_w)
    groups = -(-co // p.block_co)
    assert p.blocks * groups <= 132
    assert -(-tiles // p.blocks) == -(-tiles // (132 // groups))


def test_block_co_halves_to_fit():
    """Where 16 output channels' weights do not fit beside the halo ring,
    the planner takes 8; where 8 do not either, the CUDA-core tile, which
    refuses a kernel wider than its register window."""
    p = _plan((1, 64, 64, 64), (7, 7, 64, 32), 1, 2)
    assert p.route == "tensor_cores" and p.block_co == 16
    p = _plan((1, 64, 64, 32), (11, 11, 32, 32), 2, 2)
    assert p.route == "tensor_cores" and p.block_co == 8
    assert tplan.int_conv_mma_smem_bytes(11, 11, 16, 32, 16, 32, 2, 2) \
        > tplan.CONV_MMA_SMEM_MAX >= p.smem_bytes
    assert tplan.int_conv_mma_smem_bytes(15, 15, 16, 32, 8, 32, 2, 2) \
        > tplan.CONV_MMA_SMEM_MAX
    with pytest.raises(ValueError, match="register window"):
        _plan((1, 64, 64, 32), (15, 15, 32, 32), 2, 2)


def _widest_c(k, xb, wb, hw=4):
    """The largest C the planner sends to the tensor cores for a k x k
    kernel over an hw x hw image (SAME), scanning C from 1: past it every C
    takes the CUDA-core tile."""
    def fits(c):
        return tplan.int_conv2d_on_tensor_cores(
            (1, hw, hw, c), (k, k, c, 8), x_bytes=xb, w_bytes=wb,
            padding="SAME")
    c = 1
    while fits(c + 1):
        c += 1
    assert fits(c) and not any(fits(d) for d in range(c + 1, c + 257))
    return c


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("xb,wb", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_every_fitting_shape_keeps_the_s32_sums_in_range(xb, wb, k):
    """One run holds every tap: the shared memory caps taps * C of any
    shape the planner sends to the tensor cores far below the bound
    taps * C * max_prod < 2^31 the launcher checks, so K never needs
    folding there; a longer K takes the CUDA-core tile."""
    c = _widest_c(k, xb, wb)
    most = k * k * c * tplan.INT_CONV_MMA_MAX_PROD[(xb, wb)]
    assert most < I32 // 8
    p = _plan((1, 4, 4, c), (k, k, c, 8), xb, wb, "SAME")
    assert p.route == "tensor_cores" and p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX
    assert _plan((1, 4, 4, c + 32), (k, k, c + 32, 8), xb, wb,
                 "SAME").route == "cuda_cores"


def test_a_tap_past_the_int32_range_takes_the_cuda_cores():
    """One tap of 32,897 int16 x int16 channels could reach 2^31 in the
    cross sum: the tensor-core K6 cannot take it in one run."""
    assert not tplan.int_conv2d_on_tensor_cores(
        (1, 1, 1, 32897), (1, 1, 32897, 8), x_bytes=2, w_bytes=2)


def test_constants_match_the_kernel_source():
    """The planner's copy of the tensor-core K6's layout is the one in
    csrc/int_conv2d_mma.cu and the tile it shares with K5,
    csrc/conv_mma.cuh (the launcher re-checks every field)."""
    csrc = Path(tplan.__file__).parent.parent / "csrc"
    tile = (csrc / "conv_mma.cuh").read_text()
    src = (csrc / "int_conv2d_mma.cu").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", tile)}
    assert (c["kConvThreads"], c["kTilePixels"], c["kStages"],
            c["kConvSmemMax"]) == (
        tplan.CONV_MMA_THREADS, tplan.CONV_MMA_TILE_PIXELS,
        tplan.CONV_MMA_STAGES, tplan.CONV_MMA_SMEM_MAX)
    assert "return xrow <= 32 ? 32 : xrow <= 64 ? 64 : " \
           "(xrow + 127) / 128 * 128;" in tile
    assert all(tplan._cpad_for(n) == (32 if n <= 32 else 64 if n <= 64
                                      else -(-n // 128) * 128)
               for n in range(1, 600))
    cases = tuple(int(v) for v in
                  re.findall(r"case (\d+): return launch_variant", src))
    assert cases == tplan.INT_CONV_MMA_BLOCK_COS
    assert ("return xb == 2 && wb == 2 ? 2 * 128 * 255\n"
            "         : xb == 2 || wb == 2 ? 255 * 128\n"
            "                              : 128 * 128;") in src
    assert tplan.INT_CONV_MMA_MAX_PROD == {
        (2, 2): 2 * 128 * 255, (1, 2): 255 * 128, (2, 1): 255 * 128,
        (1, 1): 128 * 128}
    assert "const long long krow = taps * w_bytes * cpc + 16;" in src
    assert "(block_w + FW - 1) * block_c;" in src
    assert "block_c == x_bytes * cpc" in src
    assert "const long long need = block_co * krow + kStages * halo;" in src
    assert "taps * C * max_prod(x_bytes, w_bytes) < (1LL << 31);" in src


# ---------------------------------------------------------------------------
# The kernel's arithmetic
# ---------------------------------------------------------------------------

def planes(v: torch.Tensor, nbytes: int):
    """The byte planes the kernel multiplies, high first, as int64: an int8
    value is one signed plane; an int16 value v = 2^8 hi + lo is its signed
    high byte hi = v >> 8 and its unsigned low byte lo = v & 0xFF."""
    v = v.to(torch.int64)
    if nbytes == 1:
        assert int(v.min()) >= -128 and int(v.max()) <= 127
        return [v]
    hi, lo = v >> 8, v & 0xFF
    assert int(hi.min()) >= -128 and int(hi.max()) <= 127
    assert int(lo.min()) >= 0 and int(lo.max()) <= 255
    assert torch.equal(hi * 256 + lo, v)
    return [hi, lo]


def int_conv_mma_emulation(q_x, q_w, *, block_c, padding="VALID"):
    """The tensor-core K6 in plain torch: both operands split into byte
    planes, channels zero-padded to cpc = block_c / x_bytes, the image to
    its padding; for each tap and each 32-channel k step, every (x plane,
    w plane) product added to accumulator px + pw (the two int16 cross
    terms share one), every running sum held to the int32 range the MMA
    accumulator has; after the last tap the accumulators combined with 2^8
    weights, high first, in uint32 (mod 2^32).  Returns int32 [N, Ho, Wo,
    Co]."""
    xb, wb = q_x.element_size(), q_w.element_size()
    n, h, wd, c = q_x.shape
    fh, fw, _, co = q_w.shape
    cpc = block_c // xb
    top, bottom, left, right = tconv.same_pads(fh, fw, padding)
    ho, wo = h + top + bottom - fh + 1, wd + left + right - fw + 1
    xs = [F.pad(p, (0, cpc - c, left, right, top, bottom))
          for p in planes(q_x, xb)]
    ws = [F.pad(p, (0, 0, 0, cpc - c)) for p in planes(q_w, wb)]
    nacc = xb + wb - 1
    taps = fh * fw
    acc = [torch.zeros((n * ho * wo, co), dtype=torch.int64)
           for _ in range(nacc)]
    for tap in range(taps):
        i, j = divmod(tap, fw)
        for k0 in range(0, cpc, 32):
            for px, xp in enumerate(xs):
                rows = xp[:, i:i + ho, j:j + wo, k0:k0 + 32].reshape(-1, 32)
                for pw, wp in enumerate(ws):
                    acc[px + pw] += rows @ wp[i, j, k0:k0 + 32]
            for a in acc:
                assert int(a.abs().max()) < I32
    total = torch.zeros((n * ho * wo, co), dtype=torch.int64)
    for k, a in enumerate(acc):
        total = (total + ((a & 0xFFFFFFFF) << (8 * (nacc - 1 - k)))) \
            & 0xFFFFFFFF
    total = torch.where(total >= I32, total - 2**32, total)
    return total.to(torch.int32).reshape(n, ho, wo, co)


def _values(rng, shape, dtype, kind):
    info = np.iinfo(dtype)
    if kind == "min":
        return np.full(shape, info.min, dtype=dtype)
    lo, hi = ((max(info.min, -256), min(info.max + 1, 256))
              if kind == "fig4" else (info.min, info.max + 1))
    return rng.integers(lo, hi, shape).astype(dtype)


def _check(q_x, q_w, padding, plan):
    """The emulation with ``plan``'s staging equals repro's exact
    conv and the port's plain K6 on the same numpy-seeded operands."""
    want = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x), jnp.asarray(q_w),
                                          padding=padding))
    tx, tw = torch.from_numpy(q_x), torch.from_numpy(q_w)
    got = int_conv_mma_emulation(tx, tw, block_c=plan.block_c,
                                 padding=padding)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tconv.int_conv2d_torch(tx, tw, padding=padding))


# (N, H, W, C, Fh, Fw, Co, padding): ragged C (5, 37: two k steps a tap,
# the second one partly zero) and Co (3, 13, 17), C 32 (one k step), SAME
# and VALID, widths past one tile row (40) and a 16-column image.
GEOMS = [
    (1, 9, 10, 5, 3, 3, 8, "SAME"),
    (2, 7, 40, 37, 3, 2, 13, "VALID"),
    (1, 8, 16, 32, 7, 7, 3, "SAME"),
    (1, 11, 9, 17, 4, 5, 17, "VALID"),
]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "-".join(map(str, g)))
@pytest.mark.parametrize("kind", ["fig4", "full", "min"])
@pytest.mark.parametrize("xb,wb", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_emulation_equals_reference(xb, wb, kind, geom):
    """Every operand width pair, at Fig. 4's value range, the full range
    (int16 sums wrap) and every value at the type's minimum: the planner's
    tensor-core plan, emulated, is exact."""
    n, h, w, c, fh, fw, co, padding = geom
    rng = np.random.default_rng(xb * 100 + wb * 10 + c)
    q_x = _values(rng, (n, h, w, c), TYPES[xb], kind)
    q_w = _values(rng, (fh, fw, c, co), TYPES[wb], kind)
    plan = _plan(q_x.shape, q_w.shape, xb, wb, padding)
    assert plan.route == "tensor_cores"
    _check(q_x, q_w, padding, plan)


@pytest.mark.parametrize("xb,wb", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_widest_fitting_k_at_the_extremes(xb, wb):
    """The longest K the tensor cores take at 3x3 (the widest C that fits,
    zero-padded to cpc) with every value at the extreme that drives each
    accumulator hardest (int16 -32,513 = 2^8 * -128 + 255: hi -128, lo 255;
    int8 -128) stays inside the int32 range in one run and is exact."""
    c = _widest_c(3, xb, wb)
    ext = {1: -128, 2: -32513}
    q_x = np.full((1, 4, 4, c), ext[xb], dtype=TYPES[xb])
    q_w = np.full((3, 3, c, 2), ext[wb], dtype=TYPES[wb])
    plan = _plan(q_x.shape, q_w.shape, xb, wb, "SAME")
    assert plan.route == "tensor_cores"
    _check(q_x, q_w, "SAME", plan)


# ---------------------------------------------------------------------------
# Dispatch, refusals and counts
# ---------------------------------------------------------------------------

def test_dispatch_follows_the_route(monkeypatch):
    """A 'cuda' plan reaches the tensor-core wrapper on its route and the
    CUDA-core wrapper (with the tile's geometry) on the other, here CPU
    stand-ins that record the call and run the emulation / plain K6."""
    rng = np.random.default_rng(0)
    q_x = torch.from_numpy(_values(rng, (1, 9, 12, 20), np.int16, "full"))
    q_w = torch.from_numpy(_values(rng, (3, 3, 20, 6), np.int8, "full"))
    want = tconv.int_conv2d_torch(q_x, q_w, padding="SAME")
    calls = []

    def mma(x, w, *, plan, padding="VALID"):
        calls.append(("mma", plan))
        return int_conv_mma_emulation(x, w, block_c=plan.block_c,
                                      padding=padding)

    def cores(x, w, *, padding="VALID", **geometry):
        calls.append(("cores", geometry))
        return tconv.int_conv2d_torch(x, w, padding=padding)

    monkeypatch.setattr(tconv, "int_conv2d_mma_cuda", mma)
    monkeypatch.setattr(tconv, "int_conv2d_cuda", cores)
    plan = dataclasses.replace(_plan(q_x.shape, q_w.shape, 2, 1, "SAME"),
                               backend="cuda")
    assert torch.equal(ops.int_conv2d(q_x, q_w, padding="SAME", plan=plan),
                       want)
    core = tplan.int_conv2d_core_geometry(q_x.shape, q_w.shape,
                                          padding="SAME")
    on_cores = dataclasses.replace(plan, route="cuda_cores", **core)
    assert torch.equal(ops.int_conv2d(q_x, q_w, padding="SAME",
                                      plan=on_cores), want)
    assert calls == [("mma", plan), ("cores", core)]


def test_cpu_path_counts_plain_calls_only():
    rng = np.random.default_rng(1)
    q_x = torch.from_numpy(_values(rng, (1, 8, 8, 4), np.int16, "fig4"))
    q_w = torch.from_numpy(_values(rng, (3, 3, 4, 8), np.int16, "fig4"))
    tconv.reset_counts()
    got = ops.int_conv2d(q_x, q_w, padding="SAME")
    assert torch.equal(got, tconv.int_conv2d_torch(q_x, q_w, padding="SAME"))
    assert tconv.plain_calls["int_conv2d"] == 2
    assert tconv.kernel_launches == {"ulppack_conv2d": 0, "int_conv2d": 0,
                                     "ulppack_conv2d_mma": 0,
                                     "int_conv2d_mma": 0}


def test_cuda_wrapper_refuses_cpu_tensors_and_other_plans():
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int16)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int16)
    plan = _plan(tuple(x.shape), tuple(w.shape), 2, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        tconv.int_conv2d_mma_cuda(x, w, plan=plan)
    with pytest.raises(ValueError, match="tensor_cores"):
        tconv.int_conv2d_mma_cuda(x.to(torch.int8), w, plan=plan)
    with pytest.raises(ValueError, match="tensor_cores"):
        tconv.int_conv2d_mma_cuda(
            x, w, plan=dataclasses.replace(plan, route="cuda_cores"))
    with pytest.raises(TypeError, match="int8 or int16"):
        tconv.int_conv2d_mma_cuda(x.int(), w, plan=plan)
    with pytest.raises(TypeError, match="int8 or int16"):
        _plan(tuple(x.shape), tuple(w.shape), 4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.int_conv2d(x, w, backend="cuda")
    assert tconv.kernel_launches["int_conv2d_mma"] == 0
