"""K5 on the int8 tensor cores (``csrc/ulppack_conv2d_mma.cu``) from the CPU:
the planner's route by layout and its geometry at every packed layer of
full-width ``sparq-cnn``, the paper's Fig. 4 shape and the reduced config
(the weights resident, plans pinned field for field), the channel chunks
of wider convs and their fold points, the planner's constants against the
kernel's source, a plain emulation of the kernel's implicit GEMM over
lattice bytes -- chunk by chunk, s32 sums folded into uint32 totals --
against ``repro``'s ``ref.conv2d_i32_ref`` (run through JAX) and the
port's plain K5, an emulation of the fused epilogue (patch sums from a
column of ones)
against ``cnn.conv_epilogue``, the fused route's plumbing in
``cnn.conv_apply`` with a CPU stand-in, and the CUDA wrapper's refusals.
The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py -k ulppack_conv2d``).

The reference's Pallas conv fails on the installed JAX, so the oracle is
``ref.conv2d_i32_ref`` on the lattices."""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_conv2d as tconv  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

SPEC = PackSpec(2, 2)          # int16xP2s8, sparq-cnn's W2A2 layout


# ---------------------------------------------------------------------------
# The route and the planner
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.mark.parametrize("text,p2s8", [
    ("W2A2/int16xP2s8", True), ("W1A1/int16xP2s8", True),
    ("W3A3/int16xP2s8", True), ("W1A1/int8xP2s4", False),
    ("W1A1/int16xP4s4", False), ("W2A2/int32xP2s16", False),
    ("W2A2/int32xP4s8", False), ("W2A2/int32xP2s8", False)])
def test_route_by_layout(text, p2s8):
    """Every feasible layout goes to the tensor cores, as for K2.  The halo
    holds the lattice bytes of 32 channels for every layout; int16xP2s8
    (``p2s8``) and int32xP4s8 pixels read as bytes are that
    lattice and are staged as they are, every other layout's pixels are
    staged raw into one more slot, which the shared memory counts."""
    sp = PackSpec.parse(text)
    assert tplan.packed_conv2d_on_tensor_cores(sp)
    assert tplan.packed_matmul_on_tensor_cores(sp)
    cp = -(-32 // sp.n_pack)
    x_shape, w_shape = (1, 64, 64, cp), (7, 7, cp, 32)
    p = tplan.plan_packed_conv2d(x_shape, w_shape, sp)
    assert p.route == "tensor_cores"
    assert p.block_w is not None and p.blocks is not None
    assert p.stages == tplan.CONV_MMA_STAGES
    assert p.block_c == tplan.conv_mma_block_c(cp, sp.n_pack) == 32
    raw = tplan.conv_mma_raw_c(cp, sp)
    assert (raw == 0) is (p2s8 or text.endswith("int32xP4s8"))
    assert raw in (0, 16, 32, 64)
    assert p.smem_bytes == tplan.conv_mma_smem_bytes(
        7, 7, p.block_h, p.block_w, p.block_co, p.block_c, raw)
    assert (sp.lane_dtype == torch.int16 and sp.n_pack == 2) is p2s8


def _cnn_layer_shapes(cfg, batch):
    """(x_shape, w_shape, store, k_full) of every packed layer of ``cfg``
    at ``batch`` images, SAME, both weight stores."""
    sp = PackSpec.from_config(cfg.quant)
    hw, k = cfg.cnn_input_hw, cfg.cnn_kernel
    chans = cfg.cnn_channels
    out = []
    for cin, cout in zip((chans[0],) + chans[:-1], chans):
        cp = -(-cin // sp.n_pack)
        words = -(-cin // (32 // sp.w_bits))
        out.append(((batch, hw, hw, cp), (k, k, cp, cout), "lanes", None))
        out.append(((batch, hw, hw, cp), (k, k, words, cout), "dense", cin))
    return out


#: (block_h, block_w, block_co, block_c, blocks, smem_bytes) per shape:
#: sparq-cnn's layers (8 images of 256 x 256, 7x7, Cin 32: 1,024 tiles of
#: 16 x 32 pixels in 8 waves of 128 blocks), the Fig. 4 shape (250 x 250
#: VALID: 128 tiles), the reduced config (16 x 16 images, 3x3, Cin 8).
GEOMETRY = {
    ((8, 256, 256, 16), 32): (16, 32, 32, 32, 128, 32 * 1584 + 2 * 26752),
    ((8, 256, 256, 16), 64): (16, 32, 64, 32, 128, 64 * 1584 + 2 * 26752),
    ((1, 256, 256, 16), 32): (16, 32, 32, 32, 128, 32 * 1584 + 2 * 26752),
    ((2, 16, 16, 4), 8): (32, 16, 8, 32, 2, 8 * 304 + 2 * 34 * 18 * 32),
}


def _geometry_cases():
    full = configs.get_config("sparq-cnn")
    small = configs.get_config("sparq-cnn", reduced=True)
    cases = [(*c, "SAME") for c in _cnn_layer_shapes(full, 8)]
    cases += [(*c, "SAME") for c in _cnn_layer_shapes(small, 2)]
    cases.append(((1, 256, 256, 16), (7, 7, 16, 32), "lanes", None,
                  "VALID"))
    return sorted(set(cases), key=str)


@pytest.mark.parametrize("x_shape,w_shape,store,k_full,padding",
                         _geometry_cases(), ids=lambda v: str(v))
def test_tensor_core_geometry(x_shape, w_shape, store, k_full, padding):
    """int16xP2s8 plans the tensor-core K5: 512-pixel tiles, the smallest
    channel block that holds Co, a two-slot halo ring beside the resident
    weight block within the 232,448 bytes a block may use, and one wave of
    persistent blocks each walking an equal share of the tiles."""
    p = tplan.plan_packed_conv2d(x_shape, w_shape, SPEC, padding=padding,
                                 weight_store=store, k_full=k_full)
    assert (p.op, p.backend, p.weight_store) == ("packed_conv2d", "torch",
                                                 store)
    got = (p.block_h, p.block_w, p.block_co, p.block_c, p.blocks,
           p.smem_bytes)
    assert got == GEOMETRY[(x_shape, w_shape[-1])]
    assert (p.route, p.chunk_c, p.chunks) == ("tensor_cores", p.block_c, 1)
    assert p.block_h * p.block_w == tplan.CONV_MMA_TILE_PIXELS
    assert (p.threads, p.stages) == (tplan.CONV_MMA_THREADS,
                                     tplan.CONV_MMA_STAGES)
    assert p.smem_bytes == tplan.conv_mma_smem_bytes(
        w_shape[0], w_shape[1], p.block_h, p.block_w, p.block_co, p.block_c)
    assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX == 232448
    n, h, w, _ = x_shape
    out = h if padding == "SAME" else h - w_shape[0] + 1
    tiles = n * -(-out // p.block_h) * -(-out // p.block_w)
    assert p.blocks <= 132 and -(-tiles // p.blocks) == -(-tiles // 132)
    row = p.describe()
    assert row["block_w"] == p.block_w and row["blocks"] == p.blocks


def _mma_geo(x_shape, w_shape, sp, padding="SAME"):
    n, h, w, cp = x_shape
    fh, fw, _, co = w_shape
    oh, ow = tplan._conv_out(h, w, fh, fw, padding)
    return tplan._conv_mma_geometry(n, oh, ow, cp, fh, fw, co, sp, "cpu")


def test_sum_range_and_shared_memory_refusals():
    """A conv whose s32 sums over all of K could reach 2^31, and one whose
    weight block does not fit the shared memory even at 8 output channels,
    both take the tensor-core K5 in channel chunks: the first folds its
    sums into uint32 totals every ``conv_mma_fold_run`` chunks (PTX does
    not promise that the MMA wraps), the second streams each chunk's
    weights through the ring.  No plan records the CUDA-core tile."""
    sp = PackSpec.parse("W3A3/int16xP2s8")
    cp = -(-(2**31) // (2 * 49))               # 2 cp * 49 >= 2^31
    geo = _mma_geo((1, 1, 1, cp), (1, 1, cp, 8), sp, "VALID")
    p = tplan.plan_packed_conv2d((1, 1, 1, cp), (1, 1, cp, 8), sp,
                                 padding="VALID")
    assert p.route == "tensor_cores" and p.chunk_c == geo["chunk_c"]
    assert p.chunks == -(-2 * cp // p.chunk_c) > 1
    run = tplan.conv_mma_fold_run(1, 2 * cp, p.chunk_c, 49, p.chunks)
    assert 1 <= run < p.chunks and run * p.chunk_c * 49 < 2**31 \
        <= (run + 1) * p.chunk_c * 49
    ok = (2**31 - 1) // (2 * 49)               # just inside the range
    assert 2 * ok * 49 < 2**31
    assert tplan.conv_mma_fold_run(1, 2 * ok, 128, 49, 7) == 7   # no fold
    geo = _mma_geo((1, 8, 8, 512), (7, 7, 512, 8), SPEC)
    assert (geo["block_c"], geo["chunks"]) == (1024, 1024 // geo["chunk_c"])
    assert geo["chunk_c"] < geo["block_c"]
    assert tplan.conv_mma_smem_bytes(7, 7, geo["block_h"], geo["block_w"],
                                     8, 1024) > tplan.CONV_MMA_SMEM_MAX
    p = tplan.plan_packed_conv2d((1, 8, 8, 512), (7, 7, 512, 8), SPEC)
    assert p.route == "tensor_cores" and p.smem_bytes == geo["smem_bytes"]
    assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX
    assert p.smem_bytes == tplan.conv_mma_smem_bytes(
        7, 7, p.block_h, p.block_w, p.block_co, p.block_c, 0, p.chunk_c)
    p = tplan.plan_packed_conv2d((1, 8, 8, 32), (7, 7, 32, 128), SPEC)
    assert p.block_c == 64 and p.block_co == 32         # halved to fit
    assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX and p.chunks == 1
    with pytest.raises(ValueError, match="shared memory"):
        _mma_geo((1, 8, 8, 16), (25, 25, 16, 8), SPEC)


#: (x_shape, w_shape, spec, padding) -> (block_co, block_c, chunk_c,
#: chunks, smem_bytes): the wide convs that the CUDA-core tile took before
#: the chunked K loop -- Fig. 4 at 128 channels, a ResNet-18 conv4_x layer
#: (3x3 256 -> 256 at batch 64 on 14 x 14, W2A2 and W4A4's raw slot), 3x3
#: 512 -> 512, a 1x1 conv over 2,048 channels.
CHUNKED = {
    ((1, 256, 256, 64), (7, 7, 64, 32), "W2A2/int16xP2s8", "VALID"):
        (32, 128, 32, 4, 2 * (32 * (49 * 32 + 16) + 22 * 38 * 32)),
    ((64, 14, 14, 128), (3, 3, 128, 256), "W2A2/int16xP2s8", "SAME"):
        (64, 256, 64, 4, 2 * (64 * (9 * 64 + 16) + 34 * 18 * 64)),
    ((64, 14, 14, 128), (3, 3, 128, 256), "W4A4/int32xP2s16", "SAME"):
        (64, 256, 64, 4, 2 * (64 * (9 * 64 + 16) + 34 * 18 * 64)
         + 34 * 18 * 128),
    ((8, 7, 7, 256), (3, 3, 256, 512), "W2A2/int16xP2s8", "SAME"):
        (64, 512, 64, 8, 2 * (64 * (9 * 64 + 16) + 34 * 18 * 64)),
    ((1, 64, 64, 1024), (1, 1, 1024, 16), "W2A2/int16xP2s8", "SAME"):
        (16, 2048, 128, 16, 2 * (16 * (128 + 16) + 16 * 32 * 128)),
}


@pytest.mark.parametrize("key", list(CHUNKED), ids=lambda v: str(v))
def test_wide_convs_take_the_tensor_cores_in_chunks(key):
    """Shapes past the resident weight block plan the tensor-core K5 with
    the largest channel chunk whose two ring slots -- the chunk's weight
    rows and halo slice each -- fit beside the raw slot at the largest
    block_co, and the shared memory the launcher computes."""
    x_shape, w_shape, text, padding = key
    sp = PackSpec.parse(text)
    p = tplan.plan_packed_conv2d(x_shape, w_shape, sp, padding=padding)
    assert p.route == "tensor_cores"
    got = (p.block_co, p.block_c, p.chunk_c, p.chunks, p.smem_bytes)
    assert got == CHUNKED[key]
    assert p.smem_bytes <= tplan.CONV_MMA_SMEM_MAX
    fh, fw = w_shape[:2]
    raw = tplan.conv_mma_raw_c(x_shape[-1], sp, p.chunk_c)
    assert p.smem_bytes == tplan.conv_mma_smem_bytes(
        fh, fw, p.block_h, p.block_w, p.block_co, p.block_c, raw, p.chunk_c)
    bigger = [c for c in tplan._chunk_sizes(p.block_c) if c > p.chunk_c]
    assert all(tplan.conv_mma_smem_bytes(
        fh, fw, p.block_h, p.block_w, p.block_co, p.block_c,
        tplan.conv_mma_raw_c(x_shape[-1], sp, c), c)
        > tplan.CONV_MMA_SMEM_MAX for c in bigger)
    cands = tplan.packed_conv2d_candidates(x_shape, w_shape, sp,
                                           padding=padding)
    assert cands and all(c["route"] == "tensor_cores" for c in cands)
    assert {(c["block_co"], c["block_w"]) for c in cands} == {
        (b, w) for b in tplan.CONV_MMA_BLOCK_COS
        if b <= max(8, min(64, w_shape[-1])) for w in tplan.CONV_MMA_BLOCK_WS}


@pytest.mark.parametrize("cp,block_c", [(1, 32), (4, 32), (16, 32),
                                        (17, 64), (32, 64), (33, 128),
                                        (64, 128), (65, 256)])
def test_staged_bytes_per_pixel(cp, block_c):
    assert tplan.conv_mma_block_c(cp) == block_c


def test_constants_match_the_kernel_source():
    """The planner's copy of the tensor-core K5's geometry is the one in
    csrc/ulppack_conv2d_mma.cu and the tile it shares with K6,
    csrc/conv_mma.cuh (the launcher re-checks every field)."""
    csrc = Path(tplan.__file__).parent.parent / "csrc"
    src = "".join((csrc / f).read_text()
                  for f in ("conv_mma.cuh", "ulppack_conv2d_mma.cu"))
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (c["kConvThreads"], c["kTilePixels"], c["kStages"],
            c["kConvSmemMax"]) == (
        tplan.CONV_MMA_THREADS, tplan.CONV_MMA_TILE_PIXELS,
        tplan.CONV_MMA_STAGES, tplan.CONV_MMA_SMEM_MAX)
    assert c["kWarpFrags"] * 16 * c["kConvThreads"] // 32 \
        == tplan.CONV_MMA_TILE_PIXELS
    cases = tuple(int(v) for v in
                  re.findall(r"case (\d+): return launch_variant", src))
    assert cases == tplan.CONV_MMA_BLOCK_COS
    ws = tuple(int(v) for v in re.findall(r"block_w == (\d+)", src))
    assert ws == tplan.CONV_MMA_BLOCK_WS
    assert ("return xrow <= 32 ? 32 : xrow <= 64 ? 64 : "
            "(xrow + 127) / 128 * 128;") in src
    assert "const long long krow = taps * chunk_c + 16;" in src
    assert ("const long long slot = chunks == 1 ? halo : block_co * krow + "
            "halo;") in src
    assert ("const long long need = (chunks == 1 ? block_co * krow : 0) +\n"
            "                         kStages * slot + pixels * craw;") in src
    assert ("const int craw = xform == kDirect ? 0\n"
            "                   : chunks == 1    ? (xrow + 15) / 16 * 16\n"
            "                                    : chunk_c * lane_bytes / "
            "n_pack;") in src
    assert "block_c == cpad_for(static_cast<int>(xlat))" in src
    assert "chunks == (xlat + chunk_c - 1) / chunk_c;" in src
    assert ("  return taps * c * max_prod < (1LL << 31)\n"
            "             ? chunks\n"
            "             : ((1LL << 31) - 1) / (taps * chunk_ch * max_prod);"
            ) in src
    for taps, c, ch, prod, n in [(49, 64, 32, 49, 2), (1, 2**26, 128, 49,
                                                       2**19),
                                 (9, 4096, 64, 65025, 64)]:
        want = n if taps * c * prod < 2**31 else \
            (2**31 - 1) // (taps * ch * prod)
        assert tplan.conv_mma_fold_run(taps, c, ch, prod, n) == want
    assert tplan._chunk_sizes(512) == [384, 256, 128, 64, 32]
    assert all(tplan._cpad_for(c) == c for c in tplan._chunk_sizes(4096))


# ---------------------------------------------------------------------------
# The kernel's arithmetic
# ---------------------------------------------------------------------------

def weight_bytes(w, spec, store, k_full):
    """The weight block as the kernel stages it, [Fh, Fw, channels, Co] of
    u8 lattice values in channel order: an int16xP2s8 lane's byte pair
    swapped back (byte 1 holds channel 2k, byte 0 channel 2k + 1), another
    layout's field-reversed lanes unpacked, or the 'dense' words' fields
    expanded (field f of word k is channel k * per + f)."""
    fh, fw, wc, co = w.shape
    if store == "lanes" and (spec.lane_bytes, spec.n_pack) == (2, 2):
        b = w.contiguous().view(torch.uint8).reshape(fh, fw, wc, co, 2)
        return torch.stack((b[..., 1], b[..., 0]), dim=3).reshape(
            fh, fw, 2 * wc, co).to(torch.int64)
    if store == "lanes":
        return tpack.unpack(w, spec, axis=2, reversed_fields=True).to(
            torch.int64)
    per = 32 // spec.w_bits
    ch = torch.arange(k_full)
    fields = w[:, :, ch // per, :].to(torch.int64)
    return (fields >> (spec.w_bits * (ch % per))[None, None, :, None]) \
        & spec.max_w


def lattice_bytes(xp, spec):
    """The halo's lattice bytes of each pixel, [N, H, W, n_pack Cp]: lanes
    of int16xP2s8 / int32xP4s8 read as bytes (the kernel stages them as
    they are), every other layout's unpacked (the raw slot's rewrite,
    ``tests/test_torch_layouts_mma.py``)."""
    n, h, wd, cp = xp.shape
    if spec.shift == 8 and spec.n_pack == spec.lane_bytes:
        return xp.contiguous().view(torch.uint8).reshape(
            n, h, wd, spec.n_pack * cp).to(torch.int64)
    return tpack.unpack(xp, spec, axis=-1).to(torch.int64)


def conv_mma_emulation(xp, w, spec, plan, padding, store, k_full=None,
                       run=None):
    """The tensor-core K5 in plain torch: the activation lanes as lattice
    bytes zero-padded to ``chunks * chunk_c`` a pixel, the weight block as
    staged, and per pixel tile of the plan (block_h x block_w outputs of
    one image, tiles in the kernel's order) the implicit GEMM chunk by
    chunk, over taps and 32-byte k steps against the tile's zero-padded
    halo slice, with the patch sums as one more product against ones;
    every running sum held to the int32 range the MMA accumulator has.
    After the tile's last chunk, and after every ``run`` chunks before it
    (``conv_mma_fold_run``, the launcher's), the sums are added into
    uint32 totals (mod 2^32) and restarted.  Returns (acc, psum) as int32
    [N, Ho, Wo, Co] and [N, Ho, Wo, 1]."""
    n, h, wd, cp = xp.shape
    fh, fw, _, co = w.shape
    top, bottom, left, right = tconv.same_pads(fh, fw, padding)
    ho, wo = h + top + bottom - fh + 1, wd + left + right - fw + 1
    bh, bw = plan.block_h, plan.block_w
    chunk, chunks = plan.chunk_c, plan.chunks
    bc = chunk * chunks
    xb = lattice_bytes(xp, spec)
    wb = weight_bytes(w, spec, store, k_full)
    wb = F.pad(wb, (0, 0, 0, bc - wb.shape[2]))
    if run is None:
        run = tplan.conv_mma_fold_run(fh * fw, spec.n_pack * cp, chunk,
                                      spec.max_w * spec.max_a, chunks)
    tiles_h, tiles_w = -(-ho // bh), -(-wo // bw)
    ext = torch.zeros((n, tiles_h * bh + fh - 1, tiles_w * bw + fw - 1, bc),
                      dtype=torch.int64)
    ext[:, top:top + h, left:left + wd, :xb.shape[-1]] = xb
    acc = torch.zeros((n, tiles_h * bh, tiles_w * bw, co), dtype=torch.int64)
    psum = torch.zeros((n, tiles_h * bh, tiles_w * bw, 1), dtype=torch.int64)
    ones = torch.ones((32, 1), dtype=torch.int64)
    mask = 2**32 - 1
    for tile in range(n * tiles_h * tiles_w):
        b, r = divmod(tile, tiles_h * tiles_w)
        oh0, ow0 = (r // tiles_w) * bh, (r % tiles_w) * bw
        halo = ext[b, oh0:oh0 + bh + fh - 1, ow0:ow0 + bw + fw - 1]
        tot = torch.zeros((bh * bw, co), dtype=torch.int64)
        stot = torch.zeros((bh * bw, 1), dtype=torch.int64)
        d = torch.zeros((bh * bw, co), dtype=torch.int64)
        s = torch.zeros((bh * bw, 1), dtype=torch.int64)
        for k in range(chunks):
            for i in range(fh):
                for j in range(fw):
                    rows = halo[i:i + bh, j:j + bw].reshape(bh * bw, bc)
                    for k0 in range(k * chunk, (k + 1) * chunk, 32):
                        a = rows[:, k0:k0 + 32]
                        d += a @ wb[i, j, k0:k0 + 32]
                        s += a @ ones
                        assert int(d.max()) < 2**31 and int(s.max()) < 2**31
            if k == chunks - 1 or (k + 1) % run == 0:
                tot, stot = (tot + d) & mask, (stot + s) & mask
                d, s = torch.zeros_like(d), torch.zeros_like(s)
        acc[b, oh0:oh0 + bh, ow0:ow0 + bw] = tot.reshape(bh, bw, co)
        psum[b, oh0:oh0 + bh, ow0:ow0 + bw] = stot.reshape(bh, bw, 1)
    return (tpack.wrap_i32(acc[:, :ho, :wo]).to(torch.int32),
            tpack.wrap_i32(psum[:, :ho, :wo]).to(torch.int32))


# (N, H, W, Cin, Fh, Fw, Co, padding, store): odd Cin (3, 17), Cin 8 (the
# reduced config), 32 (one k step a tap), 40 and 80 (64 and 128 staged
# bytes: several steps a tap); widths past one or two tiles; Co 8 to 64 and
# one (9) that fills no channel group.
GEOMS = [
    (1, 9, 10, 3, 3, 3, 8, "SAME", "lanes"),
    (2, 7, 19, 8, 3, 3, 32, "VALID", "dense"),
    (1, 11, 37, 17, 5, 4, 64, "SAME", "dense"),
    (2, 6, 5, 32, 7, 7, 8, "SAME", "lanes"),
    (1, 13, 12, 40, 3, 3, 9, "VALID", "lanes"),
    (1, 5, 70, 80, 2, 3, 16, "SAME", "lanes"),
]


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
    return (q_x, q_w, torch.from_numpy(np.array(xp)),
            torch.from_numpy(np.array(wp)))


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "-".join(map(str, g)))
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_implicit_gemm_equals_reference(bits, geom):
    """At W1A1, W2A2 and W3A3 on int16xP2s8, both stores, SAME and VALID:
    the emulation with the planner's tiles equals repro's conv2d_i32_ref on
    the lattices and the port's plain K5, and its patch sums equal
    cnn.patch_sums of the lattice."""
    n, h, w, cin, fh, fw, co, padding, store = geom
    js = jpack.PackSpec.parse(f"W{bits}A{bits}/int16xP2s8")
    ts = PackSpec.parse(str(js))
    q_x, q_w, xp, wp = _operands(js, geom, bits * 1000 + cin + co)
    k_full = cin if store == "dense" else None
    plan = tplan.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), ts,
                                    padding=padding, weight_store=store,
                                    k_full=k_full)
    want = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x), jnp.asarray(q_w),
                                          padding=padding))
    acc, psum = conv_mma_emulation(xp, wp, ts, plan, padding, store, k_full)
    np.testing.assert_array_equal(acc.numpy(), want)
    plain = tconv.ulppack_conv2d_torch(xp, wp, ts, padding=padding,
                                       weight_store=store, k_full=k_full)
    assert torch.equal(acc, plain)
    assert torch.equal(psum, cnn.patch_sums(torch.from_numpy(q_x), fh, fw,
                                            padding))


def test_implicit_gemm_at_the_lattice_extremes():
    """Every lattice value at its maximum (W3A3: 7 x 7) over a 7x7 kernel
    and 64 channels (two k steps a tap), the most the tensor-core K5's
    shared memory takes at 7x7: the sums stay exact."""
    sp = PackSpec.parse("W3A3/int16xP2s8")
    q_x = torch.full((1, 9, 40, 64), 7, dtype=torch.int32)
    q_w = torch.full((7, 7, 64, 16), 7, dtype=torch.int32)
    xp, wp = tpack.pack_activations(q_x, sp), tpack.pack_weights(q_w, sp,
                                                                 axis=2)
    plan = tplan.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp)
    assert plan.block_c == 64
    acc, psum = conv_mma_emulation(xp, wp, sp, plan, "SAME", "lanes")
    assert int(acc.max()) == 49 * 64 * 49 and int(psum.max()) == 49 * 64 * 7
    assert torch.equal(acc, tconv.ulppack_conv2d_torch(xp, wp, sp,
                                                       padding="SAME"))


#: Layouts of the chunked rows: every lane layout of the family at the
#: lowest bits it packs (W2A2 where the tile is raw int32 lanes), and
#: int16xP2s8 at W1-W3.
WIDE_LAYOUTS = ["W1A1/int16xP2s8", "W2A2/int16xP2s8", "W3A3/int16xP2s8",
                "W1A1/int8xP2s4", "W1A1/int16xP4s4", "W2A2/int32xP2s8",
                "W2A2/int32xP4s8", "W2A2/int32xP2s16"]


def _wide_case(text, geom, seed):
    """(plan, oracle, emulation, plain) at a shape the chunked K loop
    takes."""
    n, h, w, cin, fh, fw, co, padding, store = geom
    js = jpack.PackSpec.parse(text)
    ts = PackSpec.parse(text)
    q_x, q_w, xp, wp = _operands(js, geom, seed)
    k_full = cin if store == "dense" else None
    plan = tplan.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), ts,
                                    padding=padding, weight_store=store,
                                    k_full=k_full)
    assert plan.route == "tensor_cores" and plan.chunks > 1
    want = np.asarray(jref.conv2d_i32_ref(jnp.asarray(q_x), jnp.asarray(q_w),
                                          padding=padding))
    acc, psum = conv_mma_emulation(xp, wp, ts, plan, padding, store, k_full)
    plain = tconv.ulppack_conv2d_torch(xp, wp, ts, padding=padding,
                                       weight_store=store, k_full=k_full)
    return plan, want, (acc, psum), plain, q_x


@pytest.mark.parametrize("store", ["lanes", "dense"])
@pytest.mark.parametrize("text", WIDE_LAYOUTS)
def test_chunked_7x7_c128_every_layout(text, store):
    """7x7 over 128 channels (past the resident weight block at every
    block_co), every layout and both stores -- the dense store at W3,
    whose 10-field words straddle the 32-channel chunk edges, included:
    the emulation chunk by chunk equals repro's conv2d_i32_ref and the
    plain K5, its patch sums cnn.patch_sums."""
    geom = (1, 6, 9, 128, 7, 7, 24, "SAME", store)
    plan, want, (acc, psum), plain, q_x = _wide_case(text, geom, 128)
    assert plan.chunk_c == 32 and plan.chunks == 4
    np.testing.assert_array_equal(acc.numpy(), want)
    assert torch.equal(acc, plain)
    assert torch.equal(psum, cnn.patch_sums(torch.from_numpy(q_x), 7, 7,
                                            "SAME"))


#: (N, H, W, Cin, Fh, Fw, Co, padding, store) -> (chunk_c, chunks): 3x3
#: over 256 channels; 1x1 over 2,048; Cin 65 and 33, whose last chunk is
#: mostly zero padding (33 at 13x13, where 64 staged bytes no longer stay
#: resident); a 9x9 kernel, past the CUDA-core tile's register window.
WIDE = {
    (1, 5, 6, 256, 3, 3, 16, "SAME", "lanes"): (128, 2),
    (1, 4, 5, 2048, 1, 1, 8, "SAME", "dense"): (128, 16),
    (1, 9, 10, 65, 7, 7, 9, "VALID", "lanes"): (64, 2),
    (1, 6, 7, 33, 13, 13, 8, "SAME", "dense"): (32, 2),
    (1, 9, 11, 128, 9, 9, 17, "SAME", "lanes"): (32, 4),
}


@pytest.mark.parametrize("geom", list(WIDE), ids=lambda g: "-".join(
    map(str, g)))
@pytest.mark.parametrize("bits", [2, 3])
def test_chunked_shapes_equal_reference(bits, geom):
    """The chunked K loop at W2A2 and W3A3 int16xP2s8: the planner's
    chunks, and the emulation equal to repro's conv2d_i32_ref and the plain
    K5."""
    plan, want, (acc, _), plain, _ = _wide_case(
        f"W{bits}A{bits}/int16xP2s8", geom, bits * 7 + geom[3])
    assert (plan.chunk_c, plan.chunks) == WIDE[geom]
    np.testing.assert_array_equal(acc.numpy(), want)
    assert torch.equal(acc, plain)


def test_folds_at_every_chunk_are_exact():
    """The fold arithmetic is exact at any run length: folding the s32
    sums into the uint32 totals after every chunk (the shortest run a plan
    can have) gives the same conv and patch sums as one run."""
    sp = PackSpec.parse("W3A3/int16xP2s8")
    geom = (1, 9, 10, 65, 7, 7, 9, "VALID", "lanes")
    plan, want, (acc, psum), _, _ = _wide_case(str(sp), geom, 5)
    q_x, q_w, xp, wp = _operands(jpack.PackSpec.parse(str(sp)), geom, 5)
    every = conv_mma_emulation(xp, wp, sp, plan, "VALID", "lanes", run=1)
    assert torch.equal(every[0], acc) and torch.equal(every[1], psum)
    np.testing.assert_array_equal(every[0].numpy(), want)


# ---------------------------------------------------------------------------
# The fused epilogue
# ---------------------------------------------------------------------------

def affine_emulation(acc, psum, ep: tconv.ConvAffine):
    """The kernel's epilogue in plain torch, one f32 operation at a time in
    its order: s = a_scale * w_scale; pv = w_zp * psum;
    out = s * (acc - pv)."""
    f32 = torch.float32
    s = torch.as_tensor(ep.a_scale).to(f32) * torch.as_tensor(
        ep.w_scale).to(f32)
    pv = torch.as_tensor(ep.w_zp).to(f32) * psum.to(f32)
    return s * (acc.to(f32) - pv)


def _layer(bits, w_zp, store, seed, cin=8, co=16, k=3):
    """One prepared conv layer of W{bits}A{bits} (w_zp: the config's
    midpoint, or the value given) and a float input."""
    qcfg = configs.get_config("sparq-cnn", reduced=True).quant.replace(
        w_bits=bits, a_bits=bits)
    g = torch.Generator().manual_seed(seed)
    p = cnn.conv_init(g, k, k, cin, co, qcfg)
    p = cnn.conv_prepare(p, qcfg, weight_store=store)
    if w_zp is not None:
        p["w_zp"] = torch.tensor(w_zp, dtype=torch.int32)
    x = torch.randn((2, 11, 9, cin), generator=g) * 2
    return p, x, qcfg


@pytest.mark.parametrize("bits,w_zp,store", [
    (2, None, "lanes"), (2, None, "dense"), (1, None, "lanes"),
    (3, None, "dense"), (2, 0, "lanes"), (3, 5, "lanes")])
def test_epilogue_emulation_bit_equal_to_conv_epilogue(bits, w_zp, store):
    """The epilogue in the kernel's order, on the emulated accumulator and
    patch sums (from the ones column), equals cnn.conv_epilogue on the
    plain path bit for bit, with the config's nonzero w_zp and others."""
    p, x, qcfg = _layer(bits, w_zp, store, bits * 10 + (w_zp or 0))
    core = cnn.conv_integer_core(p, x, qcfg, backend="torch")
    o = cnn._packed_operands(p, x, qcfg, "SAME", "torch", None)
    acc, psum = conv_mma_emulation(o["xp"], o["wp"], o["plan"].spec,
                                   o["plan"], "SAME", o["store"],
                                   o["k_full"])
    assert torch.equal(acc, core["acc"]) and torch.equal(psum, core["psum"])
    assert int(torch.as_tensor(core["w_zp"])) == (
        w_zp if w_zp is not None else 1 << (bits - 1))
    got = affine_emulation(acc, psum, tconv.ConvAffine(
        core["a_scale"], core["w_scale"], core["w_zp"]))
    want = cnn.conv_epilogue(core)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def _stand_in(calls):
    """A CPU stand-in for ulppack_conv2d_mma_cuda: the emulated kernel, with
    the emulated epilogue when one is asked for."""
    def run(x, w, spec, *, plan, padding="VALID", weight_store="lanes",
            k_full=None, epilogue=None):
        calls.append((plan, epilogue))
        acc, psum = conv_mma_emulation(x, w, spec, plan, padding,
                                       weight_store, k_full)
        return acc if epilogue is None else affine_emulation(acc, psum,
                                                             epilogue)
    return run


@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_conv_apply_takes_the_fused_route_on_cuda_plans(monkeypatch, store):
    """With a 'cuda' plan on int16xP2s8, cnn.conv_apply is one tensor-core
    K5 call with the affine epilogue (here a CPU stand-in that emulates the
    kernel): no plain conv, no eager patch sums; its output equals the
    plain path's.  ops.packed_conv2d on the same plan takes the s32 kernel."""
    p, x, qcfg = _layer(2, None, store, 7)
    want = cnn.conv_apply(p, x, qcfg, quant_mode="packed")
    o = cnn._packed_operands(p, x, qcfg, "SAME", "torch", None)
    plan = dataclasses.replace(o["plan"], backend="cuda")
    calls = []
    monkeypatch.setattr(tconv, "ulppack_conv2d_mma_cuda", _stand_in(calls))
    monkeypatch.setattr(cnn, "patch_sums", None)     # never called
    tconv.reset_counts()
    got = cnn.conv_apply(p, x, qcfg, quant_mode="packed", plan=plan)
    assert len(calls) == 1 and calls[0][0] is plan
    assert isinstance(calls[0][1], tconv.ConvAffine)
    assert tconv.plain_calls["ulppack_conv2d"] == 0
    assert got.dtype == torch.float32 and torch.equal(got, want)
    from repro_torch.kernels import ops
    acc = ops.packed_conv2d(o["xp"], o["wp"], plan.spec, plan=plan,
                            padding="SAME")
    assert len(calls) == 2 and calls[1][1] is None
    assert acc.dtype == torch.int32 and tconv.plain_calls["ulppack_conv2d"] \
        == 0


def test_forward_takes_the_fused_route_every_layer(monkeypatch):
    """cnn.forward with 'cuda' plans (the reduced sparq-cnn, both packed
    layers) makes one fused K5 call a layer and equals the plain forward."""
    cfg = configs.get_config("sparq-cnn", reduced=True)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    packed = cnn.prepare_packed_params(params, cfg)
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(4))
    want = cnn.forward(packed, cfg, x, quant_mode="packed")
    plans = [dataclasses.replace(p, backend="cuda")
             for p in cnn.layer_plans(packed, cfg, tuple(x.shape))]
    calls = []
    monkeypatch.setattr(tconv, "ulppack_conv2d_mma_cuda", _stand_in(calls))
    got = cnn.forward(packed, cfg, x, quant_mode="packed", plans=plans)
    assert [c[0] for c in calls] == plans
    assert all(isinstance(c[1], tconv.ConvAffine) for c in calls)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Refusals and counts
# ---------------------------------------------------------------------------

def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int16)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int16)
    plan = tplan.plan_packed_conv2d(tuple(x.shape), tuple(w.shape), SPEC)
    with pytest.raises(ValueError, match="CUDA device"):
        tconv.ulppack_conv2d_mma_cuda(x, w, SPEC, plan=plan)
    with pytest.raises(ValueError, match="CUDA device"):
        tconv.ulppack_conv2d_mma_cuda(x, w, SPEC, plan=plan,
                                      epilogue=tconv.ConvAffine(1.0, 1.0, 2))
    sp32 = PackSpec(2, 2, "int32", 2, 16)
    with pytest.raises(ValueError, match="int16xP2s8"):  # another layout's
        tconv.ulppack_conv2d_mma_cuda(x.int(), w.int(), sp32, plan=plan)
    with pytest.raises(TypeError, match="packed to int16"):
        tconv.ulppack_conv2d_mma_cuda(x.int(), w, SPEC, plan=plan)
    p, xf, qcfg = _layer(2, None, "lanes", 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cnn.conv_apply(p, xf, qcfg, quant_mode="packed", backend="cuda")
    assert tconv.kernel_launches["ulppack_conv2d_mma"] == 0


def test_cpu_path_counts_plain_calls_only():
    p, x, qcfg = _layer(2, None, "lanes", 2)
    tconv.reset_counts()
    cnn.conv_apply(p, x, qcfg, quant_mode="packed")
    assert tconv.mma_launches == {"s32": 0, "affine": 0}
    assert tconv.kernel_launches == {"ulppack_conv2d": 0, "int_conv2d": 0,
                                     "ulppack_conv2d_mma": 0,
                                     "int_conv2d_mma": 0}
    assert tconv.plain_calls["ulppack_conv2d"] == 1
