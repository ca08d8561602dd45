"""The flash-decoding kernels' plan (``plan_attention_decode``, K3/K4) and
the CUDA wrappers' refusals, on the CPU.

The plan gives the kernel's geometry -- query rows per block, splits of
whole tiles (and whole pages when paged) that cover the logical length,
rows per staged tile and shared memory per block -- beside the plain
version's group ``block_k``; csrc/attention_decode.cu refuses a plan that
breaks these rules, which the card tests check.
"""

import math

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
    the smallest tile), wider blocks two where a 64-row tile allows it."""
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
        elif p.tile_rows >= 64:
            half = plan_lib.ATTN_SMEM_MAX // 2
            assert one <= half or plan_lib.attention_smem_bytes(
                p.block_m, 64, hd, rb, 0, 128) > half


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
