"""The flash-decoding kernels' plan (``plan_attention_decode``, K3/K4) and
the CUDA wrappers' refusals, on the CPU.

The plan gives the kernel's geometry -- query rows per block, splits of
whole tiles (and whole pages when paged) that cover the logical length,
rows per staged tile and shared memory per block -- beside the plain
version's group ``block_k``; csrc/attention_decode.cu refuses a plan that
breaks these rules, which the card tests check.  Blocks of more than 4
query rows take the kernel's tile path (bf16 tensor cores): its warp
layout, its tiles and its shared memory are pinned here against the
source.
"""

import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.kernels import ulppack_attention as att  # noqa: E402

# (B, C, S, H, KVH, hd): decode and prefill windows of stablelm-1.6b's
# shapes and granite-3-8b's grouping, a long cache, an empty one, ragged
# lengths and the widest head.
SHAPES = [(4, 1, 512, 32, 32, 64), (4, 16, 512, 32, 32, 64),
          (4, 1, 512, 32, 8, 128), (4, 16, 512, 32, 8, 128),
          (3, 1, 4096, 8, 4, 64), (3, 16, 4096, 8, 4, 64),
          (1, 1, 0, 4, 2, 16), (3, 16, 200, 8, 4, 64),
          (2, 7, 333, 12, 3, 80), (1, 64, 256, 4, 4, 256),
          (1, 300, 300, 8, 8, 64), (16, 1, 512, 32, 32, 64)]
KV_BITS = [0, 16, 8, 4, 2]


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def _plan(shape, kv_bits, page_size=None):
    b, c, s, h, kvh, hd = shape
    return plan_lib.plan_attention_decode(b, c, s, h, kvh, hd, kv_bits,
                                          page_size=page_size, device="cpu")


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_splits_cover_the_cache(shape, kv_bits):
    """splits x split_rows covers S, and no split starts past it; each
    split is a whole number of tiles; the kernel's limits hold."""
    s = shape[2]
    p = _plan(shape, kv_bits)
    assert p.splits * p.split_rows >= s
    assert (p.splits - 1) * p.split_rows < max(s, 1)
    assert p.split_rows % p.tile_rows == 0
    assert p.tile_rows % 4 == 0
    if plan_lib.attention_warp_path(p.block_m, shape[5]):
        assert p.tile_rows in (32, 64, 128)
    else:   # whole k16 steps of the tensor cores' P.V
        assert p.tile_rows in plan_lib.ATTN_TILE_TILES
        assert p.tile_rows % 16 == 0
    assert 1 <= p.splits <= plan_lib.ATTN_MAX_SPLITS
    assert 1 <= p.tile_rows <= plan_lib.ATTN_MAX_TILE
    assert p.threads == plan_lib.ATTN_THREADS
    b, c, _, h, kvh, _ = shape
    assert p.block_m == max(1, min(c * h // kvh, plan_lib.ATTN_MAX_QROWS))
    assert p.smem_bytes <= plan_lib.ATTN_SMEM_MAX


@pytest.mark.parametrize("page_size", [8, 16, 32])
@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("shape", [sh for sh in SHAPES if sh[2] % 32 == 0],
                         ids=str)
def test_paged_splits_are_whole_pages(shape, kv_bits, page_size):
    """Paged, a split is a whole number of pages and of tiles; where a
    page divides a tile, K4 splits the rows exactly as K3 does (the same
    split boundaries, tiles and merge order keep K4 bit-equal to K3)."""
    p = _plan(shape, kv_bits, page_size)
    assert p.split_rows % page_size == 0
    assert p.split_rows % p.tile_rows == 0
    assert p.splits * p.split_rows >= shape[2]
    k3 = _plan(shape, kv_bits)
    assert p.tile_rows == k3.tile_rows
    if p.tile_rows % page_size == 0:
        assert (p.splits, p.split_rows) == (k3.splits, k3.split_rows)


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("page_size", [None, 16])
def test_widest_head_and_group_fit_shared_memory(kv_bits, page_size):
    """hd 256 with G x C = 64 query rows per block stays within the 232,448
    bytes a Hopper block may use."""
    p = _plan((2, 16, 4096, 16, 4, 256), kv_bits, page_size)
    assert p.block_m == 64
    assert p.smem_bytes <= 232448
    f32 = plan_lib.plan_attention_decode(
        2, 16, 4096, 16, 4, 256, kv_bits, page_size=page_size,
        cache_dtype=torch.float32, device="cpu")
    assert f32.smem_bytes <= 232448


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_smem_is_the_kernel_layout(shape, kv_bits):
    """smem_bytes is the kernel's layout at the plan's geometry, with the
    split's table entries when paged (a split of one tile has one staging
    buffer); up to 4 query rows a block fit three blocks an SM (or take
    the smallest tile), wider blocks two."""
    b, c, s, h, kvh, hd = shape
    rb = plan_lib.attention_row_bytes(hd, kv_bits)
    for ps in (None, 16):
        p = _plan(shape, kv_bits, ps)
        table = p.split_rows // ps + p.split_rows if ps else 0
        assert p.smem_bytes == plan_lib.attention_smem_bytes(
            p.block_m, p.tile_rows, hd, rb, table, p.split_rows)
        one = plan_lib.attention_smem_bytes(p.block_m, p.tile_rows, hd, rb,
                                            0, p.split_rows)
        if plan_lib.attention_warp_path(p.block_m, hd):
            assert one <= plan_lib.ATTN_SMEM_MAX // 3 or p.tile_rows == 32
        else:
            assert one <= plan_lib.ATTN_SMEM_MAX // 2


def test_one_tile_splits_are_staged_once():
    """Decode at stablelm's shapes: every split is one 128-row tile,
    staged in a single buffer, so a 16-bit cache fits three blocks an SM."""
    for kv_bits in (16, 4):
        p = _plan((4, 1, 512, 32, 32, 64), kv_bits)
        assert p.split_rows == p.tile_rows == 128
        rb = plan_lib.attention_row_bytes(64, kv_bits)
        assert p.smem_bytes < plan_lib.attention_smem_bytes(
            1, 128, 64, rb, 0, 256)


@pytest.mark.parametrize("hd,kv_bits,dtype,want", [
    (64, 4, None, 32), (64, 2, None, 16), (80, 4, None, 40),
    (64, 8, None, 64), (64, 16, None, 128), (64, 0, None, 256),
    (64, 0, torch.bfloat16, 128), (64, 16, torch.float32, 256)])
def test_row_bytes(hd, kv_bits, dtype, want):
    assert plan_lib.attention_row_bytes(hd, kv_bits, dtype) == want


def test_decode_shape_keeps_several_blocks_per_sm():
    """B4 KVH32 S512 decode: 4-8 splits of 64-128 rows, so 512-1024
    blocks, at least three per SM of the card's 132."""
    p = _plan((4, 1, 512, 32, 32, 64), 4)
    assert 4 <= p.splits <= 8 and 64 <= p.split_rows <= 128
    assert 4 * 32 * p.splits >= 3 * 132


def test_block_k_keeps_its_meaning_for_the_plain_version():
    assert _plan((4, 1, 512, 32, 32, 64), 4).block_k == 512
    assert _plan((4, 1, 200, 32, 32, 64), 4).block_k == 200
    assert _plan((4, 1, 4096, 32, 32, 64), 4, 16).block_k == 512
    assert _plan((4, 1, 48, 32, 32, 64), 4, 32).block_k == 64


def test_describe_reports_the_kernel_geometry():
    row = _plan((4, 16, 512, 32, 8, 128), 4).describe()
    for key in ("block_m", "splits", "split_rows", "tile_rows", "threads",
                "smem_bytes", "block_k"):
        assert key in row


@pytest.mark.parametrize("h,kvh,hd", [(6, 4, 64), (8, 3, 64), (8, 4, 257),
                                      (8, 4, 512)])
def test_invalid_heads_are_refused(h, kvh, hd):
    with pytest.raises(ValueError):
        plan_lib.plan_attention_decode(1, 1, 64, h, kvh, hd, 4,
                                       device="cpu")


def test_cuda_backend_refused_on_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        plan_lib.plan_attention_decode(1, 1, 64, 4, 2, 16, 4,
                                       backend="cuda", device="cpu")


def _cpu_case(kv_bits):
    b, s, h, kvh, hd = 2, 32, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    k = torch.randn((b, s, kvh, hd), generator=g)
    cache = {"k": k, "v": k.clone()}
    if kv_bits == 4:
        words = torch.zeros((b, s, kvh, hd // 8), dtype=torch.int32)
        sc = torch.ones((b, s, kvh), dtype=torch.bfloat16)
        cache = {"k": words, "v": words.clone(), "k_scale": sc,
                 "v_scale": sc.clone()}
    q = torch.randn((b, 1, h, hd), generator=g)
    vl = torch.tensor([s, 5], dtype=torch.int32)
    qpos = (vl[:, None] - 1).to(torch.int32)
    return q, cache, vl, qpos, hd


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_cuda_wrappers_raise_on_cpu_tensors(kv_bits):
    """A CPU tensor never reaches the kernels (nor nvcc): both launchers
    refuse it before building anything, and count no launch."""
    q, cache, vl, qpos, hd = _cpu_case(kv_bits)
    before = dict(att.kernel_launches)
    with pytest.raises(ValueError, match="CUDA device"):
        att.attention_decode_cuda(q, cache, vl, qpos, kv_bits=kv_bits,
                                  hd=hd)
    pool = {n: t.reshape(-1, 16, *t.shape[2:]) for n, t in cache.items()}
    bt = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        att.attention_decode_paged_cuda(q, pool, vl, qpos, bt,
                                        kv_bits=kv_bits, hd=hd)
    assert att.kernel_launches == before


def test_cpu_entry_point_takes_the_plain_version():
    """On the CPU the plan resolves to 'torch', whatever its geometry."""
    q, cache, vl, qpos, hd = _cpu_case(0)
    before = att.plain_calls["attention_decode"]
    out = att.fused_decode_attention(q, cache, vl, qpos, kv_bits=0, hd=hd)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert att.plain_calls["attention_decode"] == before + 1


def test_split_rows_rounding_uses_the_page_tile_lcm():
    """A page that does not divide the tile: split rows are a multiple of
    both."""
    p = _plan((1, 1, 960, 4, 4, 64), 4, 48)
    assert p.split_rows % math.lcm(p.tile_rows, 48) == 0


# -- the tile path: warp layout, shared memory, constants -------------------

def _a16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
@pytest.mark.parametrize("qrows", [5, 6, 8, 16, 17, 32, 33, 48, 49, 64])
def test_tile_warps_cover_the_block(qrows, tile, hd):
    """The 8 warps split as m-block groups x key slices x dim slices: the
    groups cover the m16 blocks of the rows (three take four), every key
    slice is whole k16 steps of the tile, the dim slices cover the n8
    tiles of the dims padded to 16, and a warp's accumulator holds at most
    8 n8 tiles (16 only past hd 128 with four groups)."""
    wm, wk, wd, ntw = plan_lib.attention_tile_warps(qrows, tile, hd)
    mb = -(-qrows // plan_lib.ATTN_MMA_M)
    assert wm * wk * wd == plan_lib.ATTN_WARPS
    assert wm == (4 if mb == 3 else mb) and wm * 16 >= qrows
    assert tile % wk == 0 and (tile // wk) % 16 == 0
    nt = 2 * -(-hd // 16)
    assert ntw * wd >= nt and (ntw - 1) * wd < nt
    assert ntw <= 8 or (hd > 128 and wm == 4 and ntw == 16)
    # as many key slices as the tile and the dims' split allow
    assert wk == min(tile // 16, plan_lib.ATTN_WARPS // wm // max(
        1, min(1 << (-(-nt // 8) - 1).bit_length(),
               plan_lib.ATTN_WARPS // wm)))


# (qrows, tile, hd, row_bytes, table_len, split_rows) -> bytes by region:
# q planes (3 x q16 x (hdp + 8) bf16), sums of 8 dims of q (q16 x hdp / 8
# f32), staging | carries (max of nbuf x (K, V) x tile x stride and wk x
# q16 x hdp f32), scales (2 x 2 x tile f32), four row words, merge weights
# (9 x q16), the warps' m and l, table
TILE_LAYOUTS = [
    # stablelm C16 kv16: q16 16, hdp 64, stride 144, wk 8, two buffers
    ((16, 128, 64, 128, 0, 256),
     (6912, 512, 73728, 2048, 256, 576, 1024, 0)),
    # stablelm C5 kv4 (a verify window): rows padded to 16, stride 48
    ((5, 128, 64, 32, 0, 256),
     (6912, 512, 32768, 2048, 256, 576, 1024, 0)),
    # granite C16 kv16 (G 4 x 16 = 64 rows): wk 1, one buffer, the carry
    ((64, 32, 128, 256, 0, 32),
     (52224, 4096, 32768, 512, 1024, 2304, 512, 0)),
    # 33 rows: three m16 blocks (q16 48), dims 80 (stride 176), a split of
    # one tile (one buffer), paged: 16-row pages (4 entries + 64 cells)
    ((33, 64, 80, 160, 68, 64),
     (25344, 1920, 22528, 1024, 768, 1728, 384, 272)),
    # hd 256 x 64 rows, f32 rows (stride 1040): wk 1, two dim slices
    ((64, 16, 256, 1024, 0, 512),
     (101376, 8192, 66560, 256, 1024, 2304, 512, 0)),
]


@pytest.mark.parametrize("args,parts", TILE_LAYOUTS, ids=str)
def test_tile_smem_region_by_region(args, parts):
    """The tile path's shared memory is ``tile_layout``'s regions, each
    rounded up to 16 bytes: query rows padded to m16 blocks, dims to 16,
    staged rows strided by an odd multiple of 16 bytes."""
    qrows, tile, hd, rb, table, split = args
    assert not plan_lib.attention_warp_path(qrows, hd)
    assert [_a16(x) for x in parts] == list(parts)
    assert plan_lib.attention_smem_bytes(*args) == sum(parts)
    q16 = -(-qrows // 16) * 16
    hdp = -(-hd // 16) * 16
    assert parts[0] == 2 * 3 * q16 * (hdp + 8)
    assert parts[1] == 4 * q16 * hdp // 8
    stride = _a16(rb) | 16
    assert (stride // 16) % 2 == 1
    wk = plan_lib.attention_tile_warps(qrows, tile, hd)[1]
    nbuf = 2 if split > tile else 1
    assert parts[2] == max(nbuf * 2 * tile * stride, 4 * wk * q16 * hdp)


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])     # the served caches
@pytest.mark.parametrize("shape", [(4, 5, 512, 32, 32, 64),
                                   (4, 16, 512, 32, 32, 64),
                                   (4, 1, 512, 12, 2, 128),
                                   (4, 16, 512, 12, 2, 128)], ids=str)
def test_tile_is_the_same_for_a_shard_of_the_kv_heads(shape, kv_bits):
    """The served two-shard reads (stablelm's verify windows and chunks,
    qwen2-vl's decode and chunks, half the kv heads a shard) take the
    whole read's tile and so its key slices: a read with one live split
    (the serve prompts' lengths) gives the whole read's bits, and
    qwen2-vl's splits match too."""
    b, c, s, h, kvh, hd = shape
    whole = _plan(shape, kv_bits)
    assert not plan_lib.attention_warp_path(whole.block_m, hd)
    p = _plan((b, c, s, h // 2, kvh // 2, hd), kv_bits)
    assert (p.block_m, p.tile_rows) == (whole.block_m, whole.tile_rows)
    if kvh == 2:
        assert (p.splits, p.split_rows) == (whole.splits, whole.split_rows)


def test_constants_match_the_kernel_source():
    """The planner's copy of K3/K4's constraints is the one in
    csrc/attention_decode.cu: threads, the cluster's splits, rows a block
    and a tile, the shared-memory cap, blocks an SM on each path, the
    tile path's m16 rows, q terms and tiles, and the warp path's 4 rows."""
    src = (Path(plan_lib.__file__).parent.parent / "csrc"
           / "attention_decode.cu").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (c["kThreads"], c["kMaxSplits"], c["kMaxQRows"], c["kMaxTile"],
            c["kSmemMax"], c["kMinBlocks"], c["kTileMinBlocks"],
            c["kMmaM"], c["kQTerms"], c["kWarpQ"]) == (
        plan_lib.ATTN_THREADS, plan_lib.ATTN_MAX_SPLITS,
        plan_lib.ATTN_MAX_QROWS, plan_lib.ATTN_MAX_TILE,
        plan_lib.ATTN_SMEM_MAX, plan_lib._ATTN_BLOCKS_PER_SM,
        plan_lib._ATTN_TILE_BLOCKS_PER_SM, plan_lib.ATTN_MMA_M,
        plan_lib.ATTN_Q_TERMS, 4)
    ok = re.search(r"inline bool tile_tile_ok\(int tile\) \{\s*return "
                   r"([^;]*);", src).group(1)
    assert sorted(int(v) for v in re.findall(r"tile == (\d+)", ok)) == \
        sorted(plan_lib.ATTN_TILE_TILES)
    assert "__launch_bounds__(kThreads, kTileMinBlocks)" in src
    assert "static_cast<int>(align16(row_bytes) | 16)" in src
    assert "while (wd_min * 8 < nt && wd_min * w.wm < kWarps)" in src


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("page_size", [None, 8, 16])
@pytest.mark.parametrize("shape", [(4, 5, 512, 32, 32, 64),
                                   (4, 16, 512, 32, 8, 128),
                                   (4, 16, 512, 12, 2, 128),
                                   (2, 256, 256, 16, 16, 64)], ids=str)
def test_tile_path_plans_fit_two_blocks(shape, kv_bits, page_size):
    """Verify windows, GQA-4/6 prefill chunks and the encoder's read plan
    a block that fits two an SM, with as many splits as one wave of such
    blocks holds (at most 8, and as many as the rows allow), in the
    largest tile that allows them; the plan's shared memory is the tile
    layout at its geometry."""
    b, c, s, h, kvh, hd = shape
    if page_size and s % page_size:
        pytest.skip("pages do not cover the cache")
    p = _plan(shape, kv_bits, page_size)
    assert not plan_lib.attention_warp_path(p.block_m, hd)
    rb = plan_lib.attention_row_bytes(hd, kv_bits)
    table = p.split_rows // page_size + p.split_rows if page_size else 0
    assert p.smem_bytes == plan_lib.attention_smem_bytes(
        p.block_m, p.tile_rows, hd, rb, table, p.split_rows)
    assert plan_lib.attention_smem_bytes(
        p.block_m, p.tile_rows, hd, rb, 0, p.split_rows) \
        <= plan_lib.ATTN_SMEM_MAX // 2
    pairs = b * kvh * -(-c * (h // kvh) // p.block_m)
    want = max(1, min(8, 2 * 132 // pairs))
    span = math.lcm(p.tile_rows, page_size or 1)
    assert p.splits == min(want, -(-s // span))
    for t in plan_lib.ATTN_TILE_TILES:       # no larger tile that fits
        if t > p.tile_rows:                  # two an SM allows them
            sp = math.lcm(t, page_size or 1)
            n = min(want, -(-s // sp))
            per = -(-(-(-s // n)) // sp) * sp
            assert n < want or plan_lib.attention_smem_bytes(
                p.block_m, t, hd, rb, 0, per) > plan_lib.ATTN_SMEM_MAX // 2
