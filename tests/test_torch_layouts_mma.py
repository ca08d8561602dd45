"""K2 and K5 on the int8 tensor cores for every layout of the family
(``LanesW`` / ``LanesA`` in ``csrc/mma_s8.cuh``, the raw-slot halo of
``csrc/ulppack_conv2d_mma.cu``) from the CPU:

(a) numpy emulations of the kernels' staging -- the W side's swizzled
    ring and its expand pass, the a side's split, the conv's raw-unit
    rewrite -- for every member of ``layout_family(w, a)``, w, a in 1..4,
    bit-equal to the lattice ``repro.core.packing.unpack`` gives for the
    same lanes, packed by ``repro``; the byte planes multiplied as the
    MMAs pair them, split by split in the s32 range, equal to ``repro``'s
    ``ref.matmul_i32_ref``;
(b) the planner: every feasible layout plans the tensor-core route, its
    stage lanes, split starts and the s32 range refusal in lattice
    values; a conv past the resident weight block plans the tensor cores
    in channel chunks, each chunk's raw slot a slice of whole lanes;
(c) reduced stablelm at W4A4 int32, lanes and dense: greedy tokens of
    the port's engine (``backend='torch'``, CPU) against ``repro``'s
    engine run op by op, under the top-2 margin rule;
(d) the CNN's packed layers at W4A4 ``int32xP2s16`` and W1A1
    ``int8xP2s4``: the conv emulation over the rewritten halo and the
    port's packed conv bit-equal to ``repro``'s ``ref.conv2d_i32_ref``.

The kernels themselves run on the card:
``tests/test_torch_cuda_layouts.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402

torch.set_num_threads(2)

BK, BN, PLANE_ROW = tplan.INT_MATMUL_BK, tplan.INT_MATMUL_BN, \
    tplan.INT_MATMUL_PLANE_ROW
ALL_LAYOUTS = [s for w in range(1, 5) for a in range(1, 5)
               for s in tpack.layout_family(w, a)]


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
    """Pin the reference's per-layer layout to the base spec."""
    from repro.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _jspec(sp: PackSpec):
    return jpack.PackSpec(sp.w_bits, sp.a_bits, getattr(jnp, sp.lane_name),
                          sp.n_pack, sp.shift)


def _lattices(sp, k, m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, sp.max_a + 1, (m, k)).astype(np.int32),
            rng.integers(0, sp.max_w + 1, (k, n)).astype(np.int32))


def _lane_bytes(lanes: np.ndarray, lb: int) -> np.ndarray:
    """[rows, cols] lanes as stored: [rows, cols * lb] little-endian
    bytes."""
    return np.ascontiguousarray(lanes).view(np.uint8).reshape(
        lanes.shape[0], lanes.shape[1] * lb)


# ---------------------------------------------------------------------------
# (a) The staging, emulated
# ---------------------------------------------------------------------------

def chunk_pos(sw: int, r, c):
    """csrc/mma_s8.cuh chunk_pos<SW> for SW 0 / 1 / 3 (the lanes' codes)."""
    if sw == 1:
        return c ^ (((r >> 2) & 3) << 1)
    if sw == 3:
        return c ^ (((r >> 1) & 1) << 2)
    return c


def plane_off(r, kk):
    """csrc/mma_s8.cuh plane_off: byte of (plane row r, byte kk)."""
    return r * PLANE_ROW + ((((kk >> 4) ^ (r >> 3)) & 3) << 4) + (kk & 15)


def field(words, off, f, sp: PackSpec, rev: bool):
    """LaneFields::field: field f of the lane at byte ``off`` of the
    little-endian words (numpy arrays, elementwise)."""
    bit = 8 * off + sp.shift * ((sp.n_pack - 1 - f) if rev else f)
    mask = 0xFF if sp.shift >= 8 else (1 << sp.shift) - 1
    return (words[..., bit >> 5] >> np.uint32(bit & 31)) & np.uint32(mask)


def lanes_w_stage(w_bytes: np.ndarray, sp: PackSpec, k0: int, n0: int):
    """LanesW<LB, NP, SH>: stage K steps [k0, k0 + 64) of columns [n0, n0 +
    128) of the raw weight lanes (bytes [Kp, N * LB]) -- stage_rows'
    swizzled chunks, zero past the lanes and columns -- then the expand
    pass's thread items; returns the two K-major W planes as the plane
    buffer (2 x 128 rows of PLANE_ROW bytes)."""
    lb, np_, kl = sp.lane_bytes, sp.n_pack, 2 * BK // sp.n_pack
    run = 8 // np_
    sw = 0 if lb == 4 else 3 if lb == 2 else 1
    row_bytes = BN * lb
    kp, nbytes = w_bytes.shape
    r0 = 2 * k0 // np_
    slot = np.zeros((kl, row_bytes), np.uint8)
    for r in range(kl):
        for c in range(row_bytes // 16):
            lo = n0 * lb + 16 * c
            if r0 + r < kp and lo < nbytes:
                chunk = w_bytes[r0 + r, lo:lo + 16]
                p = chunk_pos(sw, r, c)
                slot[r, 16 * p:16 * p + len(chunk)] = chunk
    planes = np.zeros(2 * BN * PLANE_ROW, np.uint8)
    nb, kb = np.meshgrid(np.arange(BN // 4), np.arange(BK // 4),
                         indexing="ij")
    x = 4 * lb * nb
    rows = []
    for i in range(run):             # the item's rows: 4 columns x LB bytes
        row = run * kb + i
        start = row * row_bytes + (chunk_pos(sw, row, x >> 4) << 4) + (x & 15)
        got = np.stack([slot.reshape(-1)[start + j] for j in range(4 * lb)],
                       axis=-1)
        rows.append(np.ascontiguousarray(got).view(np.uint32))
    for c in range(4):
        hi = np.zeros(nb.shape, np.uint32)
        lo = np.zeros(nb.shape, np.uint32)
        for i in range(8):
            v = field(rows[i // np_], c * lb, i % np_, sp, rev=True)
            if i & 1:
                lo |= v << np.uint32(8 * (i >> 1))
            else:
                hi |= v << np.uint32(8 * (i >> 1))
        d = plane_off(4 * nb + c, 4 * kb)
        for q in range(4):
            planes[d + q] = (hi >> np.uint32(8 * q)) & 0xFF
            planes[d + BN * PLANE_ROW + q] = (lo >> np.uint32(8 * q)) & 0xFF
    return planes


def unswizzled_w(planes: np.ndarray):
    """The W plane buffer as [2, 128 columns, 64 bytes]."""
    r, kk = np.meshgrid(np.arange(BN), np.arange(BK), indexing="ij")
    return np.stack([planes[p * BN * PLANE_ROW + plane_off(r, kk)]
                     for p in range(2)])


def lanes_a_stage(a_bytes: np.ndarray, sp: PackSpec, k0: int):
    """LanesA<LB, NP, SH>: stage K steps [k0, k0 + 64) of every row of the
    raw activation lanes (bytes [M, Kp * LB]; zero past the lanes), then
    the split's items; returns the two a planes [2, M, 64] (plane 0 = hi =
    odd values)."""
    lb, np_ = sp.lane_bytes, sp.n_pack
    item = 8 * lb // np_
    m, nbytes = a_bytes.shape
    l0 = 2 * k0 // np_
    row = np.zeros((m, BK * 2 * lb // np_), np.uint8)
    part = a_bytes[:, l0 * lb:l0 * lb + row.shape[1]]
    row[:, :part.shape[1]] = part
    words = row.reshape(m, 16, item).copy().view(np.uint32)   # [m, g4, w]
    hi = np.zeros((m, 16), np.uint32)
    lo = np.zeros((m, 16), np.uint32)
    for i in range(8):
        v = field(words, (i // np_) * lb, i % np_, sp, rev=False)
        if i & 1:
            hi |= v << np.uint32(8 * (i >> 1))
        else:
            lo |= v << np.uint32(8 * (i >> 1))
    return np.stack([hi, lo]).view(np.uint8).reshape(2, m, 64)


@pytest.mark.parametrize("sp", ALL_LAYOUTS, ids=str)
def test_lanes_staging_is_the_lattice(sp):
    """Each stage's W planes (LanesW; RawW's split for int16xP2s8 is the
    same bytes) and a planes (LanesA) hold lattice value 2k and 2k + 1 of
    the stage where the int16xP2s8 route puts them -- W: 2k in plane 0,
    2k + 1 in plane 1; a: 2k + 1 in plane 0, 2k in plane 1 -- bit-equal
    to ``repro.core.packing.unpack`` of the same lanes packed by
    ``repro``, with lanes and columns past the edges staged as zero."""
    m, k, n = 3, 2 * BK * 2 + 40, 150        # a ragged third stage
    qa, qw = _lattices(sp, k, m, n, sp.w_bits * 10 + sp.a_bits)
    js = _jspec(sp)
    wl = np.asarray(jpack.pack_weights(jnp.asarray(qw), js, axis=0))
    al = np.asarray(jpack.pack_activations(jnp.asarray(qa), js, axis=-1))
    lat_w = np.asarray(jpack.unpack(jnp.asarray(wl), js, axis=0,
                                    reversed_fields=True))
    lat_a = np.asarray(jpack.unpack(jnp.asarray(al), js, axis=-1))
    wb, ab = _lane_bytes(wl, sp.lane_bytes), _lane_bytes(al, sp.lane_bytes)
    steps = tplan.mma_k(wl.shape[0], sp)
    for k0 in range(0, steps, BK):
        for n0 in (0, 128):
            got = unswizzled_w(lanes_w_stage(wb, sp, k0, n0))
            want = np.zeros((2, BN, BK), np.int64)
            cols = min(BN, n - n0)
            for j in range(2):
                v = np.arange(2 * k0 + j, 2 * (k0 + BK) + j, 2)
                ok = np.flatnonzero(v < lat_w.shape[0])
                want[j][:cols, ok] = lat_w[v[ok], n0:n0 + cols].T
            assert np.array_equal(got, want), (k0, n0)
        got = lanes_a_stage(ab, sp, k0)
        for j, par in ((0, 1), (1, 0)):
            v = np.arange(2 * k0 + par, 2 * (k0 + BK) + par, 2)
            ok = v < lat_a.shape[1]
            want = np.zeros((m, BK), np.int64)
            want[:, ok] = lat_a[:, v[ok]]
            assert np.array_equal(got[j], want), (k0, j)


@pytest.mark.parametrize("text", ["W4A4/int32xP2s16", "W1A1/int8xP2s4",
                                  "W2A1/int16xP4s4", "W3A2/int32xP4s8",
                                  "W3A3/int32xP2s8"])
def test_plane_pairs_equal_the_lattice_dot(text):
    """The stages' planes multiplied as the MMAs pair them (W plane 0 x a
    plane 1 + W plane 1 x a plane 0), one s32 sum a split held to the
    int32 range, splits added in order: ``repro``'s ``matmul_i32_ref`` on
    the lattices, and ``repro``'s packed matmul on the lanes."""
    sp = PackSpec.parse(text)
    m, k, n = 5, 3 * 2 * BK + 12, 130
    qa, qw = _lattices(sp, k, m, n, 3)
    js = _jspec(sp)
    wl = np.asarray(jpack.pack_weights(jnp.asarray(qw), js, axis=0))
    al = np.asarray(jpack.pack_activations(jnp.asarray(qa), js, axis=-1))
    wb, ab = _lane_bytes(wl, sp.lane_bytes), _lane_bytes(al, sp.lane_bytes)
    steps = tplan.mma_k(wl.shape[0], sp)
    for block_k in (BK, 2 * BK, -(-steps // BK) * BK):
        total = np.zeros((m, n), np.int64)
        for s0 in range(0, steps, block_k):
            part = np.zeros((m, n), np.int64)
            for k0 in range(s0, min(steps, s0 + block_k), BK):
                a_pl = lanes_a_stage(ab, sp, k0).astype(np.int64)
                for n0 in (0, 128):
                    w_pl = unswizzled_w(lanes_w_stage(wb, sp, k0, n0))
                    cols = min(BN, n - n0)
                    w_pl = w_pl[:, :cols].astype(np.int64)
                    part[:, n0:n0 + cols] += (a_pl[1] @ w_pl[0].T
                                              + a_pl[0] @ w_pl[1].T)
            assert part.max() < 2**31
            total += part
        want = np.asarray(jref.matmul_i32_ref(jnp.asarray(qa),
                                              jnp.asarray(qw)))
        assert np.array_equal(total, want)
    lanes = np.asarray(jref.packed_matmul_ref(jnp.asarray(qa),
                                              jnp.asarray(qw), js))
    assert np.array_equal(lanes, want)


def convert_unit(unit: np.ndarray, xform: int) -> np.ndarray:
    """csrc/ulppack_conv2d_mma.cu convert_halo: one raw unit of 16 bytes as
    its lattice bytes (32 for nibbles, 8 for int32 lanes of two fields)."""
    w = unit.view(np.uint32)
    if xform == 1:
        lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
        out = np.stack([lo.view(np.uint8).reshape(4, 4),
                        hi.view(np.uint8).reshape(4, 4)], axis=-1)
        return out.reshape(32)
    sel = (0, 1) if xform == 2 else (0, 2)
    return unit.reshape(4, 4)[:, sel].reshape(8)


def xform_of(sp: PackSpec) -> int:
    if sp.shift == 8 and sp.n_pack == sp.lane_bytes:
        return 0
    if sp.shift == 4:
        return 1
    return 2 if sp.shift == 8 else 3


@pytest.mark.parametrize("sp", ALL_LAYOUTS, ids=str)
def test_halo_rewrite_is_the_lattice(sp):
    """The conv's halo: pixels of int16xP2s8 / int32xP4s8 lanes read as
    bytes, and every other layout's raw units rewritten unit by unit
    (``convert_halo``), are the pixel's lattice in channel order, zero
    past its channels: ``repro``'s unpack of the same lanes."""
    cin = 37
    rng = np.random.default_rng(sp.w_bits + 4 * sp.a_bits)
    qx = rng.integers(0, sp.max_a + 1, (6, cin)).astype(np.int32)
    js = _jspec(sp)
    xl = np.asarray(jpack.pack_activations(jnp.asarray(qx), js, axis=-1))
    lat = np.asarray(jpack.unpack(jnp.asarray(xl), js, axis=-1))
    cp = xl.shape[1]
    cpad = tplan.conv_mma_block_c(cp, sp.n_pack)
    raw_c = tplan.conv_mma_raw_c(cp, sp)
    xb = _lane_bytes(xl, sp.lane_bytes)
    for pix in range(xl.shape[0]):
        got = np.zeros(cpad, np.uint8)
        if raw_c == 0:
            got[:xb.shape[1]] = xb[pix]
        else:
            assert xform_of(sp) != 0 and raw_c % 16 == 0
            raw = np.zeros(raw_c, np.uint8)
            raw[:xb.shape[1]] = xb[pix]
            for u in range(raw_c // 16):
                out = convert_unit(raw[16 * u:16 * u + 16], xform_of(sp))
                got[len(out) * u:len(out) * (u + 1)] = out
        want = np.zeros(cpad, np.int64)
        want[:lat.shape[1]] = lat[pix]
        assert np.array_equal(got, want), pix
        assert not got[cin:].any()


# ---------------------------------------------------------------------------
# (b) The planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", ALL_LAYOUTS, ids=str)
def test_every_layout_plans_the_tensor_cores(sp):
    """K2 (lanes and dense, lanes in and the fused route) and K5 plan the
    tensor cores for every feasible layout: the tile's geometry over K
    steps of two values, a stage of ``mma_stage_lanes`` lanes, splits that
    start on whole stages and lanes, at most 32,768 lattice values a
    split; the K2 library the layout's."""
    m, k, n = 64, 5632, 2048
    kp = -(-k // sp.n_pack)
    assert tplan.packed_matmul_on_tensor_cores(sp)
    assert tplan.packed_conv2d_on_tensor_cores(sp)
    assert tplan.mma_stage_lanes(sp) == 128 // sp.n_pack
    stores = ("lanes", "dense") if sp.w_bits in tplan.DENSE_MMA_W_BITS \
        else ("lanes",)
    for store in stores:
        p = tplan.plan_packed_matmul(m, kp, n, sp, weight_store=store,
                                     k_full=k)
        steps = tplan.mma_k(kp, sp, k if store == "dense" else None)
        assert steps == -(-k // 2) or store == "lanes"
        assert p.step_k == BK and p.block_k % BK == 0
        assert 2 * p.block_k <= tplan.ULPPACK_MMA_MAX_VALUES == 32768
        assert (p.splits - 1) * p.block_k < steps <= p.splits * p.block_k
        starts = tplan.mma_split_starts(p)
        assert starts[0] == 0 and all(
            s % tplan.mma_stage_lanes(sp) == 0 for s in starts)
        assert starts == [z * 2 * p.block_k // sp.n_pack
                          for z in range(p.splits)]
        q = tplan._plan_quantized_linear(m, k, n, sp, 2, "cpu", store)
        assert q.op == "quantized_linear" and q.k_full == k
        assert (q.splits - 1) * q.block_k < -(-k // 2) <= q.splits * q.block_k
        assert q.stages >= tplan.INT_MATMUL_MIN_STAGES
    lib = build.layout_library(sp)
    assert lib in build.SOURCES
    cp = -(-32 // sp.n_pack)
    c = tplan.plan_packed_conv2d((1, 64, 64, cp), (7, 7, cp, 32), sp)
    assert c.route == "tensor_cores"


def test_split_range_refusal_in_lattice_values():
    """A tuned K2 entry of more than 16,384 K steps a split -- more than
    32,768 lattice values, whose s32 sums could pass 2^31 at fields of 255
    -- is refused; 16,384 is taken, for a layout of two fields and of
    four alike."""
    assert 255 * 255 * tplan.ULPPACK_MMA_MAX_VALUES < 2**31
    assert 255 * 255 * 2 * tplan.ULPPACK_MMA_MAX_VALUES >= 2**31
    for text in ("W4A4/int32xP2s16", "W2A2/int32xP4s8"):
        sp = PackSpec.parse(text)
        kp = 3 * 16384 * 2 // sp.n_pack
        k = tplan.mma_k(kp, sp)
        w_tile = tplan.lanes_w_tile_bytes(sp)
        a_bytes = tplan.mma_a_bytes(sp)
        geo = tplan._adopt_mma({"block_m": 8, "block_k": 16384}, k, a_bytes,
                               w_tile)
        assert geo["splits"] == 3
        with pytest.raises(ValueError, match="32896 lattice values"):
            tplan._adopt_mma({"block_m": 8, "block_k": 16384 + BK}, k,
                             a_bytes, w_tile)


def test_rings_hold_three_stages():
    """64 rows of f32 x against int32 lanes of two fields leave a ring of
    two stages: the planner takes another block_m, and the candidates
    leave that one out."""
    sp = PackSpec.parse("W4A4/int32xP2s16")
    w_tile = tplan.lanes_w_tile_bytes(sp)
    assert tplan.int_matmul_smem_layout(64, 8, 2, w_tile=w_tile,
                                        a_planes=2)[0] == 2
    q = tplan._plan_quantized_linear(64, 2048, 2048, sp, 4, "cpu", "lanes")
    assert q.block_m != 64 and q.stages >= 3
    cands = tplan.packed_matmul_candidates(64, 1024, 2048, sp,
                                           x_dtype=torch.float32, k_full=2048)
    assert cands and all(c["block_m"] != 64 and c["stages"] >= 3
                         for c in cands)
    q = tplan._plan_quantized_linear(64, 2048, 2048, sp, 2, "cpu", "lanes")
    assert q.stages >= 3


def test_oversized_conv_takes_the_cuda_cores():
    """A conv whose weight block and halo do not fit the tensor cores'
    shared memory whole plans the tensor cores in channel chunks (route
    'tensor_cores'), for every layout: the raw slot of a layout whose
    lanes are not lattice bytes holds one chunk's lanes, and the CUDA-core
    tile's geometry is on no plan."""
    for sp in {str(s): s for s in ALL_LAYOUTS}.values():
        cp = -(-2048 // sp.n_pack)
        x_shape, w_shape = (1, 8, 8, cp), (7, 7, cp, 8)
        p = tplan.plan_packed_conv2d(x_shape, w_shape, sp)
        assert p.route == "tensor_cores" and p.block_w is not None
        assert p.chunks == -(-2048 // p.chunk_c) > 1
        raw = tplan.conv_mma_raw_c(cp, sp, p.chunk_c)
        assert raw == (0 if xform_of(sp) == 0 else
                       p.chunk_c * sp.lane_bytes // sp.n_pack)
        assert raw % 16 == 0 and raw * sp.n_pack % sp.lane_bytes == 0
        assert p.smem_bytes == tplan.conv_mma_smem_bytes(
            7, 7, p.block_h, p.block_w, p.block_co, p.block_c, raw,
            p.chunk_c) <= tplan.CONV_MMA_SMEM_MAX


@pytest.mark.parametrize("sp", ALL_LAYOUTS, ids=str)
@pytest.mark.parametrize("chunk_c", [32, 64])
def test_chunked_halo_rewrite_is_the_lattice(sp, chunk_c):
    """A chunked plan's halo slice k: pixels of int16xP2s8 / int32xP4s8
    lanes read as bytes from byte k * chunk_c, every other layout's raw
    slice of ``conv_mma_raw_c(.., chunk_c)`` bytes from byte k * that
    (whole lanes) rewritten unit by unit, is lattice channels k * chunk_c
    .. (k + 1) * chunk_c - 1 of the pixel, zero past its channels."""
    cin = 101
    rng = np.random.default_rng(sp.w_bits + 4 * sp.a_bits + chunk_c)
    qx = rng.integers(0, sp.max_a + 1, (3, cin)).astype(np.int32)
    js = _jspec(sp)
    xl = np.asarray(jpack.pack_activations(jnp.asarray(qx), js, axis=-1))
    lat = np.asarray(jpack.unpack(jnp.asarray(xl), js, axis=-1))
    cp = xl.shape[1]
    raw_c = tplan.conv_mma_raw_c(cp, sp, chunk_c)
    xb = _lane_bytes(xl, sp.lane_bytes)
    chunks = -(-sp.n_pack * cp // chunk_c)
    for pix in range(xl.shape[0]):
        row = np.zeros(chunks * max(raw_c, chunk_c), np.uint8)
        row[:xb.shape[1]] = xb[pix]
        want = np.zeros(chunks * chunk_c, np.int64)
        want[:lat.shape[1]] = lat[pix]
        for k in range(chunks):
            if raw_c == 0:
                got = row[k * chunk_c:(k + 1) * chunk_c]
            else:
                raw = row[k * raw_c:(k + 1) * raw_c]
                got = np.concatenate([convert_unit(raw[16 * u:16 * u + 16],
                                                   xform_of(sp))
                                      for u in range(raw_c // 16)])
            assert np.array_equal(got, want[k * chunk_c:(k + 1) * chunk_c])


# ---------------------------------------------------------------------------
# (c) W4A4 serving, reduced stablelm
# ---------------------------------------------------------------------------

PROMPTS, NEW, MAX_LEN, CHUNK = (5, 11), 3, 32, 8


def _serve(module, cfg, params, **kw):
    eng = module.ServingEngine(cfg, params, config=module.EngineConfig(
        max_batch=2, max_len=MAX_LEN, prefill_chunk=CHUNK, **kw),
        **({"device": "cpu"} if module.__name__.startswith("repro_torch")
           else {}))
    rng = np.random.default_rng(7)
    reqs = [module.Request(i, rng.integers(0, cfg.vocab_size, n)
                           .astype(np.int32), max_new_tokens=NEW)
            for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.output) for r in reqs], reqs


def _margin_ok(jcfg, jp, tcfg, tp, prompt, tokens, i):
    """The top-2 margin rule (ROADMAP Queue 3): a divergence at token i
    counts only where the reference's top-2 logit margin there exceeds
    twice the largest difference of the two logit rows."""
    from repro.models import lm as jlm
    from repro.serve import prepare as jprepare
    from repro_torch.models import lm as tlm
    from repro_torch.serve import prepare as tprepare
    seq = np.concatenate([prompt, np.asarray(tokens[:i], np.int32)])[None]
    with jax.disable_jit():
        want = np.asarray(jlm.forward(
            jprepare.prepare_serving_params(jp, jcfg), jcfg,
            {"tokens": jnp.asarray(seq)}, quant_mode="packed")[0][0, -1],
            np.float32)
    got = tlm.forward(tprepare.prepare_serving_params(tp, tcfg, device="cpu"),
                      tcfg, {"tokens": torch.as_tensor(seq)},
                      quant_mode="packed")[0][0, -1].float().numpy()
    top = np.sort(want)[-2:]
    return float(top[1] - top[0]) <= 2 * float(np.abs(got - want).max())


@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_w4a4_engine_tokens_equal_the_reference(base_layouts, store):
    """Reduced stablelm-1.6b at W4A4 int32 (int32xP2s16, the only W4A4
    layout), kv 4: the port's engine (CPU, plain versions) against
    ``repro``'s engine run op by op, lanes and dense stores; a request may
    part only under the top-2 margin rule."""
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro.models import lm as jlm
    from repro.serve import engine as jengine
    from repro_torch import bridge
    from repro_torch.serve import engine as tengine
    kw = dict(param_dtype="float32", compute_dtype="float32")
    q = dict(enabled=True, w_bits=4, a_bits=4, lane_dtype="int32",
             kv_bits=4)
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(**q), **kw)
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(**q), **kw)
    assert str(PackSpec.from_config(tcfg.quant)) == "W4A4/int32xP2s16"
    jp = jlm.init_params(jax.random.PRNGKey(5), jcfg)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    dense = dict(dense_store=True) if store == "dense" else {}
    got, reqs = _serve(tengine, tcfg, tp, **dense)
    with jax.disable_jit():
        want, _ = _serve(jengine, jcfg, jp, **dense)
    assert all(len(o) == NEW for o in got)
    for r, g, w in zip(reqs, got, want):
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is not None:
            assert _margin_ok(jcfg, jp, tcfg, tp, np.asarray(r.prompt), w,
                              i), (r.uid, g, w)


# ---------------------------------------------------------------------------
# (d) The CNN's packed layers
# ---------------------------------------------------------------------------

def conv_emulation(qx: np.ndarray, qw: np.ndarray, sp: PackSpec,
                   padding: str) -> np.ndarray:
    """The tensor-core K5 from the halo on: the activation pixels as the
    halo holds them (packed by ``repro``, read as bytes or rewritten
    unit by unit), the weights' fields in channel order, every tap's
    lattice bytes multiplied as u8 x u8 into one s32 sum, held to the
    int32 range."""
    js = _jspec(sp)
    n, h, w, cin = qx.shape
    xl = np.asarray(jpack.pack_activations(jnp.asarray(qx), js, axis=-1))
    cp = xl.shape[-1]
    xb = _lane_bytes(xl.reshape(-1, cp), sp.lane_bytes)
    raw_c = tplan.conv_mma_raw_c(cp, sp)
    chans = sp.n_pack * cp
    halo = np.zeros((xb.shape[0], chans), np.int64)
    for pix in range(xb.shape[0]):
        if raw_c == 0:
            halo[pix] = xb[pix, :chans]
            continue
        raw = np.zeros(raw_c, np.uint8)
        raw[:xb.shape[1]] = xb[pix]
        out = np.concatenate([convert_unit(raw[16 * u:16 * u + 16],
                                           xform_of(sp))
                              for u in range(raw_c // 16)])
        halo[pix] = out[:chans]
    halo = halo.reshape(n, h, w, chans)
    fh, fw, _, co = qw.shape
    wl = np.zeros((fh, fw, chans, co), np.int64)
    wl[:, :, :cin] = qw
    if padding == "SAME":
        top, left = (fh - 1) // 2, (fw - 1) // 2
        halo = np.pad(halo, ((0, 0), (top, fh - 1 - top),
                             (left, fw - 1 - left), (0, 0)))
    oh, ow = halo.shape[1] - fh + 1, halo.shape[2] - fw + 1
    acc = np.zeros((n, oh, ow, co), np.int64)
    for i in range(fh):
        for j in range(fw):
            acc += np.einsum("nhwc,co->nhwo", halo[:, i:i + oh, j:j + ow],
                             wl[i, j])
    assert acc.max() < 2**31
    return acc


@pytest.mark.parametrize("text", ["W4A4/int32xP2s16", "W1A1/int8xP2s4"])
def test_cnn_packed_layers_equal_the_reference(text):
    """Every packed layer of the reduced sparq-cnn at W4A4 int32xP2s16 and
    W1A1 int8xP2s4, both stores: the conv emulation over the rewritten
    halo and the port's packed conv (the planner's tensor-core plan, the
    plain version on the CPU) bit-equal to ``repro``'s
    ``ref.conv2d_i32_ref``."""
    sp = PackSpec.parse(text)
    cfg = tconfigs.get_config("sparq-cnn", reduced=True)
    chans, k = cfg.cnn_channels, cfg.cnn_kernel
    rng = np.random.default_rng(11)
    for cin, co in zip((chans[0],) + chans[:-1], chans):
        qx = rng.integers(0, sp.max_a + 1, (2, 9, 11, cin)).astype(np.int32)
        qw = rng.integers(0, sp.max_w + 1, (k, k, cin, co)).astype(np.int32)
        want = np.asarray(jref.conv2d_i32_ref(jnp.asarray(qx),
                                              jnp.asarray(qw), "SAME"))
        assert np.array_equal(conv_emulation(qx, qw, sp, "SAME"), want)
        xp = tpack.pack_activations(torch.as_tensor(qx), sp)
        for store in ("lanes", "dense"):
            wp = (ops.dense_store_conv_weights(torch.as_tensor(qw),
                                               sp.w_bits)
                  if store == "dense"
                  else tpack.pack_weights(torch.as_tensor(qw), sp, axis=2))
            plan = tplan.plan_packed_conv2d(
                tuple(xp.shape), tuple(wp.shape), sp, weight_store=store,
                k_full=cin if store == "dense" else None)
            assert plan.route == "tensor_cores"
            got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding="SAME")
            assert np.array_equal(got.numpy(), want), (cin, co, store)
