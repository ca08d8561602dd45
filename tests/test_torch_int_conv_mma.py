"""K6 on the int8 tensor cores (``csrc/int_conv2d_mma.cu``) from the CPU: the
planner's route by shape and operand width and its geometry (the Fig. 4
shape, sparq-cnn's widths with the weights resident, the wider shapes in
channel chunks), the planner's constants against the kernel's source, a
plain emulation of the kernel's byte-plane arithmetic -- signed high and
unsigned low planes, chunk by chunk, three s32 sums held to the int32
range, the uint32 combine and the folds into uint32 totals -- against
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

#: (x_shape, w_shape, x_bytes, w_bytes, padding, route, (chunk_c, chunks)):
#: the Fig. 4 shape and sparq-cnn's widths (C 32, 7x7, Co 32 / 64) keep the
#: weights resident at every width, as C 64 at 7x7 does with int8
#: activations; int16 ones at C 64 or 33, C 65 and a 1x1 conv over 2,048
#: int16 channels split K into chunks of 32, 64 or 128 channels; a 9x9
#: kernel (past the CUDA-core tile's register window) stays resident.
ROUTES = [
    ((1, 256, 256, 32), (7, 7, 32, 32), 2, 2, "VALID", "tensor_cores",
     (64, 1)),
    ((1, 256, 256, 32), (7, 7, 32, 32), 1, 1, "VALID", "tensor_cores",
     (32, 1)),
    ((8, 256, 256, 32), (7, 7, 32, 64), 2, 2, "SAME", "tensor_cores",
     (64, 1)),
    ((8, 256, 256, 32), (7, 7, 32, 32), 2, 1, "SAME", "tensor_cores",
     (64, 1)),
    ((1, 256, 256, 64), (7, 7, 64, 32), 1, 2, "VALID", "tensor_cores",
     (64, 1)),
    ((1, 256, 256, 64), (7, 7, 64, 32), 1, 1, "VALID", "tensor_cores",
     (64, 1)),
    ((1, 256, 256, 64), (7, 7, 64, 32), 2, 2, "VALID", "tensor_cores",
     (64, 2)),
    ((1, 256, 256, 64), (7, 7, 64, 32), 2, 1, "VALID", "tensor_cores",
     (64, 2)),
    ((1, 256, 256, 33), (7, 7, 33, 32), 2, 2, "VALID", "tensor_cores",
     (64, 2)),
    ((1, 64, 64, 65), (7, 7, 65, 32), 1, 1, "SAME", "tensor_cores",
     (64, 2)),
    ((1, 64, 64, 2048), (1, 1, 2048, 16), 2, 2, "SAME", "tensor_cores",
     (128, 32)),
    ((1, 64, 64, 128), (3, 3, 128, 16), 1, 1, "SAME", "tensor_cores",
     (128, 1)),
    ((2, 19, 23, 5), (9, 9, 5, 17), 2, 2, "SAME", "tensor_cores", (64, 1)),
]


@pytest.mark.parametrize("x_shape,w_shape,xb,wb,padding,route,chunking",
                         ROUTES, ids=lambda v: str(v))
def test_route_by_shape_and_width(x_shape, w_shape, xb, wb, padding, route,
                                  chunking):
    """Every shape plans the tensor-core K6: the weights resident (one
    chunk of block_c bytes) where they fit beside the halo ring, else the
    largest channel chunk whose two ring slots fit; the shared memory the
    launcher computes, within the 232,448 bytes a block may use."""
    assert tplan.int_conv2d_on_tensor_cores(
        x_shape, w_shape, x_bytes=xb, w_bytes=wb, padding=padding) is (
            route == "tensor_cores")
    p = _plan(x_shape, w_shape, xb, wb, padding)
    assert (p.op, p.backend, p.route) == ("int_conv2d", "torch", route)
    assert (p.x_bytes, p.w_bytes) == (xb, wb)
    row = p.describe()
    assert row["route"] == route and row["x_bytes"] == xb
    assert (p.chunk_c, p.chunks) == chunking == (row["chunk_c"],
                                                 row["chunks"])
    assert p.block_c == xb * tplan._cpad_for(x_shape[-1])
    assert (p.chunks == 1) is (p.chunk_c == p.block_c)
    assert p.chunks == -(-x_shape[-1] * xb // p.chunk_c)
    assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX == 232448
    assert p.smem_bytes == tplan.int_conv_mma_smem_bytes(
        *w_shape[:2], p.block_h, p.block_w, p.block_co, x_shape[-1], xb, wb,
        p.chunk_c)
    core = tplan.int_conv2d_core_geometry(x_shape, w_shape, padding=padding) \
        if w_shape[1] <= tplan.CONV_FW_MAX else None
    assert core is None or core["smem_bytes"] <= tplan.CONV_SMEM_MAX


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
    assert (p.route, p.chunk_c, p.chunks) == ("tensor_cores", p.block_c, 1)
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
    the planner takes 8; where 8 do not either, channel chunks; a kernel
    whose ring of 32-channel chunks does not fit at 8 channels has no
    route."""
    p = _plan((1, 64, 64, 64), (7, 7, 64, 32), 1, 2)
    assert p.route == "tensor_cores" and p.block_co == 16
    p = _plan((1, 64, 64, 32), (11, 11, 32, 32), 2, 2)
    assert p.route == "tensor_cores" and p.block_co == 8 and p.chunks == 1
    assert tplan.int_conv_mma_smem_bytes(11, 11, 16, 32, 16, 32, 2, 2) \
        > tplan.CONV_MMA_SMEM_MAX >= p.smem_bytes
    assert tplan.int_conv_mma_smem_bytes(15, 15, 16, 32, 8, 32, 2, 2) \
        > tplan.CONV_MMA_SMEM_MAX
    p = _plan((1, 64, 64, 64), (9, 9, 64, 32), 2, 2)
    assert (p.block_co, p.chunk_c, p.chunks) == (8, 64, 2)
    with pytest.raises(ValueError, match="shared memory"):
        _plan((1, 64, 64, 64), (11, 11, 64, 32), 2, 2)


def _widest_c(k, xb, wb, hw=4):
    """The largest C whose weights the planner keeps resident for a k x k
    kernel over an hw x hw image (SAME), scanning C from 1: past it every C
    takes channel chunks."""
    def resident(c):
        return _plan((1, hw, hw, c), (k, k, c, 8), xb, wb,
                     "SAME").chunks == 1
    c = 1
    while resident(c + 1):
        c += 1
    assert resident(c) and not any(resident(d) for d in range(c + 1, c + 257))
    return c


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("xb,wb", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_every_fitting_shape_keeps_the_s32_sums_in_range(xb, wb, k):
    """A resident plan holds every tap in one run: the shared memory caps
    taps * C of those shapes far below the bound taps * C * max_prod <
    2^31, so they never fold; a longer K takes channel chunks, each of
    whose sums stays in range, and folds where the whole K could reach
    2^31."""
    c = _widest_c(k, xb, wb)
    prod = tplan.INT_CONV_MMA_MAX_PROD[(xb, wb)]
    assert k * k * c * prod < I32 // 8
    p = _plan((1, 4, 4, c), (k, k, c, 8), xb, wb, "SAME")
    assert p.route == "tensor_cores" and p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX
    q = _plan((1, 4, 4, c + 32), (k, k, c + 32, 8), xb, wb, "SAME")
    assert q.route == "tensor_cores" and q.chunks > 1
    ch = q.chunk_c // xb
    assert k * k * ch * prod < I32
    assert tplan.conv_mma_fold_run(k * k, c + 32, ch, prod, q.chunks) \
        == q.chunks


def test_a_tap_past_the_int32_range_takes_the_cuda_cores():
    """One tap of 32,897 int16 x int16 channels could reach 2^31 in the
    cross sum: the tensor-core K6 takes it in chunks of 64 channels and
    folds its sums into uint32 totals before they can (after 514 chunks of
    the 515)."""
    assert tplan.int_conv2d_on_tensor_cores(
        (1, 1, 1, 32897), (1, 1, 32897, 8), x_bytes=2, w_bytes=2)
    p = _plan((1, 1, 1, 32897), (1, 1, 32897, 8), 2, 2)
    assert (p.route, p.chunk_c, p.chunks) == ("tensor_cores", 128, 515)
    prod = tplan.INT_CONV_MMA_MAX_PROD[(2, 2)]
    assert 32897 * prod >= I32
    run = tplan.conv_mma_fold_run(1, 32897, 64, prod, p.chunks)
    assert run == 514 and run * 64 * prod < I32 <= (run + 1) * 64 * prod


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
    assert "(block_w + FW - 1) * chunk_c;" in src
    assert "block_c == x_bytes * cpad_for(C)" in src
    assert "chunks == (C + cpc - 1) / cpc;" in src
    assert ("const long long slot = chunks == 1 ? halo : block_co * krow + "
            "halo;") in src
    assert ("const long long need = (chunks == 1 ? block_co * krow : 0) + "
            "kStages * slot;") in src
    assert ("conv_mma::fold_run(taps, C, cpc, max_prod(x_bytes, w_bytes), "
            "chunks);") in src
    assert ("  return taps * c * max_prod < (1LL << 31)\n"
            "             ? chunks\n"
            "             : ((1LL << 31) - 1) / (taps * chunk_ch * max_prod);"
            ) in tile


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


def int_conv_mma_emulation(q_x, q_w, *, plan, padding="VALID", run=None):
    """The tensor-core K6 in plain torch: both operands split into byte
    planes, channels zero-padded to ``chunks`` chunks of cpc = chunk_c /
    x_bytes, the image to its padding; chunk by chunk, for each tap and
    each 32-channel k step, every (x plane, w plane) product added to
    accumulator px + pw (the two int16 cross terms share one), every
    running sum held to the int32 range the MMA accumulator has.  After the
    tile's last chunk, and after every ``run`` chunks before it
    (``conv_mma_fold_run``, the launcher's), the accumulators are combined
    with 2^8 weights, high first, in uint32 (mod 2^32), added into the
    uint32 total and restarted.  Returns int32 [N, Ho, Wo, Co]."""
    xb, wb = q_x.element_size(), q_w.element_size()
    n, h, wd, c = q_x.shape
    fh, fw, _, co = q_w.shape
    cpc, chunks = plan.chunk_c // xb, plan.chunks
    top, bottom, left, right = tconv.same_pads(fh, fw, padding)
    ho, wo = h + top + bottom - fh + 1, wd + left + right - fw + 1
    xs = [F.pad(p, (0, chunks * cpc - c, left, right, top, bottom))
          for p in planes(q_x, xb)]
    ws = [F.pad(p, (0, 0, 0, chunks * cpc - c)) for p in planes(q_w, wb)]
    nacc = xb + wb - 1
    taps = fh * fw
    if run is None:
        run = tplan.conv_mma_fold_run(
            taps, c, cpc, tplan.INT_CONV_MMA_MAX_PROD[(xb, wb)], chunks)
    mask = 2**32 - 1
    total = torch.zeros((n * ho * wo, co), dtype=torch.int64)
    acc = [torch.zeros_like(total) for _ in range(nacc)]
    for k in range(chunks):
        for tap in range(taps):
            i, j = divmod(tap, fw)
            for k0 in range(k * cpc, (k + 1) * cpc, 32):
                for px, xp in enumerate(xs):
                    rows = xp[:, i:i + ho, j:j + wo, k0:k0 + 32].reshape(-1,
                                                                         32)
                    for pw, wp in enumerate(ws):
                        acc[px + pw] += rows @ wp[i, j, k0:k0 + 32]
                for a in acc:
                    assert int(a.abs().max()) < I32
        if k == chunks - 1 or (k + 1) % run == 0:
            for m, a in enumerate(acc):
                total = (total + ((a & mask) << (8 * (nacc - 1 - m)))) & mask
            acc = [torch.zeros_like(total) for _ in range(nacc)]
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
    got = int_conv_mma_emulation(tx, tw, plan=plan, padding=padding)
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


# (N, H, W, C, Fh, Fw, Co, padding): the chunked K loop -- 3x3 over 256
# channels, 1x1 over 2,048, C 65 and 33 (a last chunk of one or two
# channels), a 9x9 kernel over 128 channels.
WIDE = [
    (1, 5, 6, 256, 3, 3, 8, "SAME"),
    (1, 3, 4, 2048, 1, 1, 9, "SAME"),
    (1, 9, 10, 65, 7, 7, 5, "VALID"),
    (1, 8, 9, 33, 7, 7, 16, "SAME"),
    (1, 9, 11, 128, 9, 9, 17, "SAME"),
]


@pytest.mark.parametrize("geom", WIDE, ids=lambda g: "-".join(map(str, g)))
@pytest.mark.parametrize("xb,wb", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_chunked_emulation_equals_reference(xb, wb, geom):
    """Every operand width pair over its full range (int16 sums wrap), at
    the shapes whose K the planner splits into chunks (with int8
    activations some of them stay resident): the emulation of the plan is
    exact."""
    n, h, w, c, fh, fw, co, padding = geom
    rng = np.random.default_rng(xb * 100 + wb * 10 + c + fh)
    q_x = _values(rng, (n, h, w, c), TYPES[xb], "full")
    q_w = _values(rng, (fh, fw, c, co), TYPES[wb], "full")
    plan = _plan(q_x.shape, q_w.shape, xb, wb, padding)
    assert plan.route == "tensor_cores"
    assert plan.chunks > 1 or xb == 1
    _check(q_x, q_w, padding, plan)


@pytest.mark.parametrize("kind", ["full", "extreme"])
def test_folded_sums_are_exact(kind):
    """32,897 int16 x int16 channels in one tap (the cross sum could pass
    2^31 in one run): 515 chunks folded into the uint32 total after the
    514th, exact against repro's conv at the full range and with every
    value at the extreme that drives each accumulator hardest; the same
    with a fold after every chunk."""
    c = 32897
    rng = np.random.default_rng(c)
    if kind == "full":
        q_x = _values(rng, (1, 1, 2, c), np.int16, "full")
        q_w = _values(rng, (1, 1, c, 8), np.int16, "full")
    else:
        q_x = np.full((1, 1, 2, c), -32513, dtype=np.int16)
        q_w = np.full((1, 1, c, 8), -32513, dtype=np.int16)
    plan = _plan(q_x.shape, q_w.shape, 2, 2)
    assert (plan.chunks, plan.chunk_c) == (515, 128)
    _check(q_x, q_w, "VALID", plan)
    tx, tw = torch.from_numpy(q_x), torch.from_numpy(q_w)
    assert torch.equal(int_conv_mma_emulation(tx, tw, plan=plan, run=1),
                       tconv.int_conv2d_torch(tx, tw))


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
        return int_conv_mma_emulation(x, w, plan=plan, padding=padding)

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
