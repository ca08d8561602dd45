"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: every test skips (inside the ``hopper`` fixture,
never at import) unless a CUDA device of capability (9, 0) or newer is
present.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_pack, ulppack_attention  # noqa: E402
from repro_torch.kernels import ulppack_conv2d, ulppack_matmul  # noqa: E402
from repro_torch.models import attention  # noqa: E402

pytestmark = pytest.mark.cuda


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
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("m,k", [(1, 7), (5, 37), (64, 2048)])
@pytest.mark.parametrize("spec", ["W2A2/int16xP2s8", "W2A2/int32xP4s8",
                                  "W4A4/int32xP2s16"])
def test_quantize_pack_bit_equal(hopper, m, k, spec):
    sp = PackSpec.parse(spec)
    x = torch.randn((m, k), generator=_gen(hopper), device=hopper) * 2
    scale = torch.tensor(0.4, device=hopper)
    zp = torch.tensor(1 << (sp.a_bits - 1), dtype=torch.int32, device=hopper)
    got = quant_pack.quantize_pack_cuda(x, scale, zp, sp)
    want = quant_pack.quantize_pack_torch(x, scale, zp, sp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,kp,n", [(1, 5, 3), (4, 1024, 2048), (7, 300, 130),
                                    (64, 1024, 5632)])
@pytest.mark.parametrize("spec", ["W2A2/int16xP2s8", "W2A2/int32xP2s16",
                                  "W2A2/int32xP4s8"])
def test_ulppack_matmul_bit_equal(hopper, m, kp, n, spec):
    """The CUDA-core K2 with its own geometry, at every layout (int16xP2s8
    too, though the planner sends that layout to the tensor cores)."""
    sp = PackSpec.parse(spec)
    g = _gen(hopper, m + n)
    qa = torch.randint(0, 4, (m, kp * sp.n_pack), generator=g, device=hopper)
    qw = torch.randint(0, 4, (kp * sp.n_pack, n), generator=g, device=hopper)
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    assert plan_lib.plan_packed_matmul(m, kp, n, sp, weight_store="lanes",
                                       device=hopper).backend == "cuda"
    got = ulppack_matmul.ulppack_matmul_cuda(
        a, w, sp, **plan_lib.packed_matmul_core_geometry(m, kp, n, sp,
                                                         hopper))
    assert torch.equal(got, ulppack_matmul.ulppack_matmul_torch(a, w, sp))


def _mma_case(dev, bits, m, kp, n, seed):
    sp = PackSpec.parse(f"W{bits}A{bits}/int16xP2s8")
    g = _gen(dev, seed)
    qa = torch.randint(0, sp.max_a + 1, (m, 2 * kp), generator=g,
                       device=dev)
    qw = torch.randint(0, sp.max_w + 1, (2 * kp, n), generator=g,
                       device=dev)
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    return sp, a, w, plan_lib.plan_packed_matmul(m, kp, n, sp,
                                                 weight_store="lanes",
                                                 device=dev)


@pytest.mark.parametrize("kp,n", [(100, 200), (1024, 2048), (333, 130),
                                  (2816, 72)])
@pytest.mark.parametrize("m", [1, 4, 9, 17, 64, 65])
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_ulppack_matmul_mma_bit_equal(hopper, bits, m, kp, n):
    """The tensor-core K2 against the plain K2, bit-equal, with the
    planner's splits, with one split and with one stage a split; M that
    fills no 8-row group, N and Kp that are no multiple of the tile."""
    import dataclasses

    sp, a, w, plan = _mma_case(hopper, bits, m, kp, n, m + kp + n)
    assert plan.backend == "cuda" and plan.block_n == 128
    want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)
    one = dataclasses.replace(plan, block_k=-(-kp // 64) * 64, splits=1)
    many = dataclasses.replace(plan, block_k=64, splits=-(-kp // 64))
    for p in (plan, one, many):
        got = ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=p)
        assert torch.equal(got, want), p.describe()
    assert torch.equal(ops.packed_matmul(a, w, sp, plan=plan), want)


def test_ulppack_matmul_mma_repeats_and_graph_replay(hopper):
    """Split-K tickets go back to 0: two launches, three calls in a row
    and the calls replayed from a CUDA graph all give the same bits."""
    sp, a, w, plan = _mma_case(hopper, 2, 4, 1024, 2048, 5)
    assert plan.splits > 1
    want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)

    def call():
        return ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=plan)

    runs = [call() for _ in range(3)]
    assert all(torch.equal(r, want) for r in runs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(3)]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


def test_ulppack_matmul_mma_long_k_at_extremes(hopper):
    """Kp = 40,000 lanes of 0xFFFF (both bytes 255, the worst byte-plane
    sums) and random lanes: the longest split (16384 lanes) keeps the s32
    sums in range, and the total wraps mod 2^32 like an int64 sum of the
    byte products, with the planner's splits and the longest."""
    import dataclasses

    sp = PackSpec.parse("W2A2/int16xP2s8")
    m, kp, n = 9, 40000, 70
    g = _gen(hopper, 11)
    for fill in (True, False):
        if fill:
            a = torch.full((m, kp), -1, dtype=torch.int16, device=hopper)
            w = torch.full((kp, n), -1, dtype=torch.int16, device=hopper)
        else:
            a = torch.randint(-2**15, 2**15, (m, kp), generator=g,
                              device=hopper, dtype=torch.int16)
            w = torch.randint(-2**15, 2**15, (kp, n), generator=g,
                              device=hopper, dtype=torch.int16)
        a64, w64 = a.to(torch.int64), w.to(torch.int64)
        lo_a, hi_a = (a64 & 0xFF).double(), ((a64 >> 8) & 0xFF).double()
        lo_w, hi_w = (w64 & 0xFF).double(), ((w64 >> 8) & 0xFF).double()
        exact = (lo_a @ hi_w + hi_a @ lo_w).to(torch.int64)   # < 2^53
        want = packing.wrap_i32(exact)
        plan = plan_lib.plan_packed_matmul(m, kp, n, sp,
                                           weight_store="lanes", device=hopper)
        longest = dataclasses.replace(
            plan, block_k=plan_lib.ULPPACK_MMA_MAX_BLOCK_K, splits=3)
        for p in (plan, longest):
            got = ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=p)
            assert torch.equal(got, want), p.describe()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 64])
def test_quantized_linear_fused_epilogue_bit_equal(hopper, out_dtype, bias,
                                                   m):
    """ops.quantized_linear on the card: one launch of the tensor-core K2
    with K1 folded into its staging and the affine epilogue fused in,
    bit-equal to K1 + K2 + the eager epilogue (the same function with the
    plain backend).  tests/test_torch_quant_fused.py holds the fused route
    against the two-launch route at every dtype."""
    sp = PackSpec(2, 2)
    k, n = 2048, 5632 if m == 64 else 200
    g = _gen(hopper, m + n)
    w = torch.randn((k, n), generator=g, device=hopper) * 0.05
    zp = torch.tensor(2, dtype=torch.int32, device=hopper)
    w_scale = torch.tensor(0.021, device=hopper)
    a_scale = torch.tensor(0.37, device=hopper)
    wp, cs = ops.prepare_weights(w, w_scale, zp, sp)
    b = None if bias is None else (
        torch.randn((n,), generator=g, device=hopper).to(bias))
    x = torch.randn((2, m // 2, k), generator=g, device=hopper)
    args = (x, wp, cs, a_scale, zp, w_scale, zp, sp)
    ulppack_matmul.reset_counts()
    quant_pack.reset_counts()
    got = ops.quantized_linear(*args, bias=b, out_dtype=out_dtype)
    assert ulppack_matmul.mma_launches == {"s32": 0, "affine": 0,
                                           "quant_affine": 1}
    assert ulppack_matmul.kernel_launches["ulppack_matmul"] == 0
    assert quant_pack.kernel_launches == 0
    want = ops.quantized_linear(*args, bias=b, out_dtype=out_dtype,
                                backend="torch")
    assert got.dtype == out_dtype and got.shape == (2, m // 2, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("change", [
    dict(block_n=64), dict(step_k=32), dict(stages=3), dict(threads=128),
    dict(block_m=24), dict(block_m=16), dict(smem_bytes=16),
    dict(splits=1), dict(block_k=16448, splits=None)])
def test_ulppack_matmul_mma_launcher_refuses_a_plan_that_disagrees(hopper,
                                                                   change):
    """A plan whose tile, shared memory, split count or split length
    (above 16384 lanes) disagrees with the kernel's layout is refused by
    the launcher and raises.  (smem_bytes and splits move by the amount
    given, None sets splits to 1; the other fields are set.)"""
    import dataclasses

    sp, a, w, plan = _mma_case(hopper, 2, 8, 600, 70, 3)

    def moved(f, v):
        if f == "splits":
            return 1 if v is None else plan.splits + v
        return plan.smem_bytes + v if f == "smem_bytes" else v

    bad = dataclasses.replace(plan, **{f: moved(f, v)
                                       for f, v in change.items()})
    assert torch.equal(
        ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=plan),
        ulppack_matmul.ulppack_matmul_torch(a, w, sp))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=bad)


# (B, pages of 16 rows, H, KVH, hd, valid_len): the small case, granite-3-8b's
# grouping (32 query heads on 8 kv heads of 128), a long cache (several
# splits) whose live lengths are multiples neither of the plan's rows per
# split nor of a page, and qwen2-vl's and jamba's groups of 6 and 8 at hd
# 128 (their decode takes the tile path).  Row 2 is dead.  The contiguous
# test cuts the small cache to S = 200 rows, no whole number of tiles.
# C 1 takes the kernel's warp path where G <= 4, C 5 and 16 its tile path.
ATTN_SHAPES = {"small": (3, 13, 8, 4, 64, (200, 37, 0)),
               "gqa": (3, 32, 32, 8, 128, (512, 301, 0)),
               "long": (3, 256, 8, 4, 64, (4001, 1234, 0)),
               "g6": (3, 32, 12, 2, 128, (512, 301, 0)),
               "g8": (3, 32, 32, 4, 128, (512, 301, 0))}
PAGE = 16


def _attn_case(dev, kv_bits, c, shape, seed):
    """A contiguous cache [B, S, KVH, ...] (``shape``: a key of
    ATTN_SHAPES or such a tuple), the same logical rows laid out
    in a pool through a scrambled block table (a random permutation of the
    physical pages; entries past a row's live pages point anywhere), q, the
    live lengths and the query positions."""
    b, n_pages, h, kvh, hd, vl = ATTN_SHAPES.get(shape, shape)
    s = n_pages * PAGE
    g = _gen(dev, seed)
    k = torch.randn((b, s, kvh, hd), generator=g, device=dev)
    v = torch.randn((b, s, kvh, hd), generator=g, device=dev)
    if kv_bits in (8, 4, 2):
        qk, sk = attention.kv_quantize(k, kv_bits)
        qv, sv = attention.kv_quantize(v, kv_bits)
        cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        dt = torch.bfloat16 if kv_bits == 16 else torch.float32
        cache = {"k": k.to(dt), "v": v.to(dt)}
    perm = torch.randperm(b * n_pages, generator=g, device=dev)
    bt = perm.reshape(b, n_pages).to(torch.int32)
    pool = {}
    for name, t in cache.items():
        p = torch.zeros((b * n_pages, PAGE, *t.shape[2:]), dtype=t.dtype,
                        device=dev)
        p[bt.long()] = t.reshape(b, n_pages, PAGE, *t.shape[2:])
        pool[name] = p
    valid_len = torch.tensor(vl, dtype=torch.int32, device=dev)
    live = -(-vl[1] // PAGE)
    bt[1, live:] = -5 + 1000 * torch.arange(n_pages - live, device=dev,
                                            dtype=torch.int32)
    q = torch.randn((b, c, h, hd), generator=g, device=dev)
    qpos = (torch.clamp(valid_len, min=c)[:, None] - c
            + torch.arange(c, device=dev)[None, :]).to(torch.int32)
    return q, cache, pool, bt, valid_len, qpos, hd


@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_attention_decode_matches_plain(hopper, kv_bits, c, shape):
    """f32 queries: kernel and plain version differ only in summation
    order, so they agree to 1e-4; the dead row is exactly zero."""
    q, cache, _, _, valid_len, qpos, hd = _attn_case(hopper, kv_bits, c,
                                                     shape, kv_bits)
    if shape == "small":
        cache = {n: t[:, :200].contiguous() for n, t in cache.items()}
    got = ulppack_attention.attention_decode_cuda(q, cache, valid_len, qpos,
                                                  kv_bits=kv_bits, hd=hd)
    want = ulppack_attention.attention_decode_torch(
        q, cache, valid_len, qpos, kv_bits=kv_bits, hd=hd, block_k=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[2].any()


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_attention_decode_launches_are_bit_equal(hopper, kv_bits, qdtype):
    """Two launches on the same inputs give the same bits (the splits merge
    in a fixed order, with no float atomics), contiguous and paged."""
    q, cache, pool, bt, vl, qpos, hd = _attn_case(hopper, kv_bits, 16,
                                                  "gqa", 7 + kv_bits)
    q = q.to(qdtype)
    runs = [ulppack_attention.attention_decode_cuda(
        q, cache, vl, qpos, kv_bits=kv_bits, hd=hd) for _ in range(2)]
    runs += [ulppack_attention.attention_decode_paged_cuda(
        q, pool, vl, qpos, bt, kv_bits=kv_bits, hd=hd) for _ in range(2)]
    assert runs[0].dtype == qdtype
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("field,delta", [("splits", 1), ("split_rows", 8),
                                         ("tile_rows", 1), ("smem_bytes", 16),
                                         ("threads", 32), ("block_m", 65)])
def test_attention_launcher_refuses_a_plan_that_disagrees(hopper, paged,
                                                          field, delta):
    import dataclasses

    q, cache, pool, bt, vl, qpos, hd = _attn_case(hopper, 4, 1, "small", 3)
    b, c, h, _ = q.shape
    kvh = cache["k"].shape[2]
    plan = plan_lib.plan_attention_decode(
        b, c, bt.shape[1] * PAGE, h, kvh, hd, 4,
        page_size=PAGE if paged else None, device=hopper)
    bad = dataclasses.replace(plan, **{field: getattr(plan, field) + delta})
    with pytest.raises(RuntimeError, match="CUDA error"):
        if paged:
            ulppack_attention.attention_decode_paged_cuda(
                q, pool, vl, qpos, bt, kv_bits=4, hd=hd, plan=bad)
        else:
            ulppack_attention.attention_decode_cuda(
                q, cache, vl, qpos, kv_bits=4, hd=hd, plan=bad)


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
@pytest.mark.parametrize("h,kvh,c", [(4, 4, 5), (12, 2, 1), (4, 4, 17),
                                     (12, 2, 8)])
def test_attention_tile_rows_not_a_multiple_of_16(hopper, h, kvh, c,
                                                  kv_bits):
    """Blocks of 5, 6 and 17 query rows (m16 blocks partly padded) and of
    48 (three m16 blocks: a fourth group of warps idle): within 1e-4 of
    the plain version, K4 through the scrambled table bit-equal to K3, the
    dead row zero."""
    b, n_pages, hd = 3, 24, 64 if h == kvh else 128
    q, cache, pool, bt, vl, qpos, hd = _attn_case(
        hopper, kv_bits, c, (b, n_pages, h, kvh, hd, (384, 301, 0)), 11 + c)
    plan = plan_lib.plan_attention_decode(b, c, n_pages * PAGE, h, kvh, hd,
                                          kv_bits, device=hopper)
    assert plan.block_m == c * h // kvh
    assert not plan_lib.attention_warp_path(plan.block_m, hd)
    got = ulppack_attention.attention_decode_cuda(q, cache, vl, qpos,
                                                  kv_bits=kv_bits, hd=hd)
    want = ulppack_attention.attention_decode_torch(
        q, cache, vl, qpos, kv_bits=kv_bits, hd=hd, block_k=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, ulppack_attention.attention_decode_paged_cuda(
        q, pool, vl, qpos, bt, kv_bits=kv_bits, hd=hd))
    assert not got[2].any()


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_attention_every_key_admitted_in_four_chunks(hopper, qdtype):
    """The encoder's read: C 256 over 256 bf16 keys with every key
    admitted (valid_len 256, every query at 255), H16 hd64 -- four chunks
    of 64 query rows a kv head: within 1e-4 of the plain version (f32 q;
    plus one bf16 ulp with bf16 q), two launches bit-equal."""
    b, s, h, hd = 2, 256, 16, 64
    g = _gen(hopper, 5)
    q = torch.randn((b, s, h, hd), generator=g, device=hopper).to(qdtype)
    cache = {n: torch.randn((b, s, h, hd), generator=g,
                            device=hopper).bfloat16() for n in ("k", "v")}
    vl = torch.full((b,), s, dtype=torch.int32, device=hopper)
    qpos = torch.full((b, s), s - 1, dtype=torch.int32, device=hopper)
    plan = plan_lib.plan_attention_decode(b, s, s, h, h, hd, 0,
                                          cache_dtype=torch.bfloat16,
                                          device=hopper)
    assert plan.block_m == 64
    got = ulppack_attention.attention_decode_cuda(q, cache, vl, qpos,
                                                  kv_bits=0, hd=hd)
    want = ulppack_attention.attention_decode_torch(
        q, cache, vl, qpos, kv_bits=0, hd=hd, block_k=512).float()
    rtol = 1e-4 if qdtype == torch.float32 else 2.0 ** -7
    assert ((got.float() - want).abs() <= 1e-4 + rtol * want.abs()).all()
    assert torch.equal(got, ulppack_attention.attention_decode_cuda(
        q, cache, vl, qpos, kv_bits=0, hd=hd))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("field,delta", [("splits", 1), ("split_rows", 16),
                                         ("tile_rows", 8), ("tile_rows", 48),
                                         ("smem_bytes", 16),
                                         ("block_m", 16)])
def test_attention_tile_launcher_refuses_a_plan_that_disagrees(
        hopper, paged, field, delta):
    """On the tile path (C16 over granite's grouping: 64 rows a block) the
    launcher refuses a tile that is not 16, 32, 64 or 128 rows, a split
    count or split that does not cover the cache, and shared memory or
    rows that are not its layout's."""
    import dataclasses

    q, cache, pool, bt, vl, qpos, hd = _attn_case(hopper, 4, 16, "gqa", 3)
    b, c, h, _ = q.shape
    kvh = cache["k"].shape[2]
    plan = plan_lib.plan_attention_decode(
        b, c, bt.shape[1] * PAGE, h, kvh, hd, 4,
        page_size=PAGE if paged else None, device=hopper)
    assert not plan_lib.attention_warp_path(plan.block_m, hd)
    bad = dataclasses.replace(plan, **{field: getattr(plan, field) + delta})
    with pytest.raises(RuntimeError, match="CUDA error"):
        if paged:
            ulppack_attention.attention_decode_paged_cuda(
                q, pool, vl, qpos, bt, kv_bits=4, hd=hd, plan=bad)
        else:
            ulppack_attention.attention_decode_cuda(
                q, cache, vl, qpos, kv_bits=4, hd=hd, plan=bad)


# (N, H, W, Cin, Fh, Fw, Co, padding)
CONV_GEOMS = [(2, 40, 37, 32, 7, 7, 64, "SAME"),
              (1, 23, 70, 13, 4, 4, 9, "VALID"),
              (3, 9, 8, 6, 3, 2, 40, "SAME"),
              (1, 256, 256, 32, 7, 7, 32, "VALID")]


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=lambda g: "x".join(
    map(str, g)))
@pytest.mark.parametrize("spec,store", [
    ("W2A2/int16xP2s8", "lanes"), ("W2A2/int16xP2s8", "dense"),
    ("W1A1/int8xP2s4", "lanes"), ("W2A2/int32xP4s8", "dense"),
    ("W3A3/int16xP2s8", "lanes"), ("W3A3/int32xP4s8", "lanes"),
    ("W4A4/int32xP2s16", "dense")])
def test_ulppack_conv2d_bit_equal(hopper, spec, store, geom):
    n, h, w, cin, fh, fw, co, padding = geom
    sp = PackSpec.parse(spec)
    g = _gen(hopper, cin + co)
    qx = torch.randint(0, sp.max_a + 1, (n, h, w, cin), generator=g,
                       device=hopper)
    qw = torch.randint(0, sp.max_w + 1, (fh, fw, cin, co), generator=g,
                       device=hopper)
    xp = packing.pack_activations(qx, sp)
    wp = (ops.dense_store_conv_weights(qw, sp.w_bits) if store == "dense"
          else packing.pack_weights(qw, sp, axis=2))
    k_full = cin if store == "dense" else None
    plan = plan_lib.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp,
                                       padding=padding, weight_store=store,
                                       k_full=k_full, device=hopper)
    assert plan.backend == "cuda"
    got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding=padding)
    want = ulppack_conv2d.ulppack_conv2d_torch(
        xp, wp, sp, padding=padding, weight_store=store, k_full=k_full)
    assert torch.equal(got, want)


# (N, H, W, Cin, Fh, Fw, Co, padding, store): the CPU emulation's grid
# (tests/test_torch_ulppack_conv_mma.py), then full-width sparq-cnn's
# layers at batch 1, both stores.
CONV_MMA_GEOMS = [
    (1, 9, 10, 3, 3, 3, 8, "SAME", "lanes"),
    (2, 7, 19, 8, 3, 3, 32, "VALID", "dense"),
    (1, 11, 37, 17, 5, 4, 64, "SAME", "dense"),
    (2, 6, 5, 32, 7, 7, 8, "SAME", "lanes"),
    (1, 13, 12, 40, 3, 3, 9, "VALID", "lanes"),
    (1, 5, 70, 80, 2, 3, 16, "SAME", "lanes"),
    (1, 256, 256, 32, 7, 7, 32, "SAME", "lanes"),
    (1, 256, 256, 32, 7, 7, 32, "SAME", "dense"),
    (1, 256, 256, 32, 7, 7, 64, "SAME", "lanes"),
    (1, 256, 256, 32, 7, 7, 64, "SAME", "dense"),
]


def _conv_mma_case(dev, bits, geom, seed):
    n, h, w, cin, fh, fw, co, padding, store = geom
    sp = PackSpec.parse(f"W{bits}A{bits}/int16xP2s8")
    g = _gen(dev, seed)
    qx = torch.randint(0, sp.max_a + 1, (n, h, w, cin), generator=g,
                       device=dev)
    qw = torch.randint(0, sp.max_w + 1, (fh, fw, cin, co), generator=g,
                       device=dev)
    xp = packing.pack_activations(qx, sp)
    wp = (ops.dense_store_conv_weights(qw, sp.w_bits) if store == "dense"
          else packing.pack_weights(qw, sp, axis=2))
    k_full = cin if store == "dense" else None
    plan = plan_lib.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp,
                                       padding=padding, weight_store=store,
                                       k_full=k_full, device=dev)
    kw = dict(padding=padding, weight_store=store, k_full=k_full)
    return sp, xp, wp, plan, kw


@pytest.mark.parametrize("geom", CONV_MMA_GEOMS, ids=lambda g: "-".join(
    map(str, g)))
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_ulppack_conv2d_mma_bit_equal(hopper, bits, geom):
    """The tensor-core K5 against the plain K5, bit-equal, through the
    planner's route (ops.packed_conv2d) and the wrapper; one launch each,
    no CUDA-core K5 launch."""
    sp, xp, wp, plan, kw = _conv_mma_case(hopper, bits, geom, bits + geom[3])
    assert plan.backend == "cuda" and plan.block_w is not None
    want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)
    ulppack_conv2d.reset_counts()
    got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding=kw["padding"])
    assert torch.equal(got, want)
    got = ulppack_conv2d.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=plan, **kw)
    assert torch.equal(got, want)
    assert ulppack_conv2d.kernel_launches["ulppack_conv2d_mma"] == 2
    assert ulppack_conv2d.kernel_launches["ulppack_conv2d"] == 0
    assert ulppack_conv2d.mma_launches == {"s32": 2, "affine": 0}


def test_ulppack_conv2d_mma_repeats_and_graph_replay(hopper):
    """Two launches, three calls in a row and the calls replayed from a
    CUDA graph give the same bits (sparq-cnn's 32->64 layer, 2 images)."""
    geom = (2, 256, 256, 32, 7, 7, 64, "SAME", "lanes")
    sp, xp, wp, plan, kw = _conv_mma_case(hopper, 2, geom, 9)
    want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)

    def call():
        return ulppack_conv2d.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=plan,
                                                      **kw)

    runs = [call() for _ in range(3)]
    assert all(torch.equal(r, want) for r in runs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(3)]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("store", ["lanes", "dense"])
@pytest.mark.parametrize("shape", [(2, 19, 37, 8, 3, 16),
                                   (1, 64, 70, 32, 7, 64)])
def test_ulppack_conv2d_mma_fused_epilogue_bit_equal(hopper, store, shape):
    """cnn.conv_apply on the card: one tensor-core K5 launch with the
    affine dequant fused in, bit-equal to the plain K5 + the eager patch
    sums and epilogue (cnn.conv_epilogue on the 'torch' backend)."""
    from repro_torch import configs
    from repro_torch.models import cnn

    n, h, w, cin, k, co = shape
    qcfg = configs.get_config("sparq-cnn").quant
    g = _gen(hopper, h + co)
    p = cnn.conv_prepare(cnn.conv_init(g, k, k, cin, co, qcfg,
                                       device=hopper), qcfg,
                         weight_store=store)
    x = torch.randn((n, h, w, cin), generator=g, device=hopper) * 2
    ulppack_conv2d.reset_counts()
    got = cnn.conv_apply(p, x, qcfg, quant_mode="packed")
    assert ulppack_conv2d.mma_launches == {"s32": 0, "affine": 1}
    assert sum(ulppack_conv2d.plain_calls.values()) == 0
    want = cnn.conv_epilogue(cnn.conv_integer_core(p, x, qcfg,
                                                   backend="torch"))
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("change", [
    dict(block_w=64), dict(block_h=8), dict(block_co=24), dict(block_c=64),
    dict(stages=3), dict(threads=128), dict(blocks=0), dict(blocks=1000),
    dict(smem_bytes=16), dict(chunk_c=64), dict(chunks=2),
    dict(chunk_c=16, chunks=2)])
def test_ulppack_conv2d_mma_launcher_refuses_a_plan_that_disagrees(hopper,
                                                                   change):
    """A plan whose tile, channel block, staged bytes, ring, threads, block
    count or shared memory disagrees with the kernel's layout is refused by
    the launcher and raises (smem_bytes moves by the amount given; the
    other fields are set)."""
    import dataclasses

    geom = (1, 40, 37, 32, 7, 7, 64, "SAME", "lanes")
    sp, xp, wp, plan, kw = _conv_mma_case(hopper, 2, geom, 3)
    bad = dataclasses.replace(plan, **{
        f: plan.smem_bytes + v if f == "smem_bytes" else v
        for f, v in change.items()})
    assert torch.equal(
        ulppack_conv2d.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=plan, **kw),
        ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ulppack_conv2d.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=bad, **kw)


@pytest.mark.parametrize("geom", CONV_MMA_GEOMS[:4] + CONV_MMA_GEOMS[-2:],
                         ids=lambda g: "-".join(map(str, g)))
def test_ulppack_conv2d_core_tile_at_int16xP2s8(hopper, geom):
    """The CUDA-core K5 with its own geometry forced on int16xP2s8 (the
    layout the planner sends to the tensor cores) stays bit-equal."""
    sp, xp, wp, plan, kw = _conv_mma_case(hopper, 2, geom, 5)
    core = plan_lib.packed_conv2d_core_geometry(
        tuple(xp.shape), tuple(wp.shape), padding=kw["padding"],
        device=hopper)
    got = ulppack_conv2d.ulppack_conv2d_cuda(xp, wp, sp, **core, **kw)
    assert torch.equal(got, ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp,
                                                                **kw))


#: (N, H, W, Cin, Fh, Fw, Co, padding): shapes past the tensor-core K5's
#: resident weight block, which it takes in channel chunks -- Fig. 4 at
#: 128 channels (one tile row), 3x3 over 256 channels at several images,
#: Cin 65 and 97 (a mostly padded last chunk), a 1x1 conv over 2,048
#: channels, a 9x9 kernel.
K5_WIDE = [(1, 30, 70, 128, 7, 7, 32, "VALID"),
           (5, 14, 14, 256, 3, 3, 40, "SAME"),
           (1, 21, 19, 65, 7, 7, 9, "VALID"),
           (1, 20, 23, 97, 7, 7, 8, "SAME"),
           (2, 16, 40, 2048, 1, 1, 24, "SAME"),
           (1, 19, 23, 128, 9, 9, 17, "SAME")]
K5_WIDE_LAYOUTS = [("W1A1/int16xP2s8", "lanes"), ("W2A2/int16xP2s8", "lanes"),
                   ("W2A2/int16xP2s8", "dense"), ("W3A3/int16xP2s8", "dense"),
                   ("W1A1/int8xP2s4", "lanes"), ("W1A1/int16xP4s4", "dense"),
                   ("W2A2/int32xP2s8", "lanes"), ("W2A2/int32xP4s8", "dense"),
                   ("W4A4/int32xP2s16", "lanes"),
                   ("W4A4/int32xP2s16", "dense")]


@pytest.mark.parametrize("geom", K5_WIDE, ids=lambda g: "x".join(
    map(str, g)))
@pytest.mark.parametrize("spec,store", K5_WIDE_LAYOUTS)
def test_ulppack_conv2d_mma_chunked_bit_equal(hopper, spec, store, geom):
    """The tensor-core K5 over channel chunks (the planner's route, one
    launch, no CUDA-core launch) at every layout and both stores, the dense
    store at W3 included: bit-equal to the plain K5 and, where its register
    window takes the kernel, to the CUDA-core tile; the fused epilogue
    bit-equal to cnn.conv_epilogue."""
    from repro_torch.models import cnn

    n, h, w, cin, fh, fw, co, padding = geom
    sp = PackSpec.parse(spec)
    g = _gen(hopper, cin + co + fh)
    qx = torch.randint(0, sp.max_a + 1, (n, h, w, cin), generator=g,
                       device=hopper)
    qw = torch.randint(0, sp.max_w + 1, (fh, fw, cin, co), generator=g,
                       device=hopper)
    xp = packing.pack_activations(qx, sp)
    wp = (ops.dense_store_conv_weights(qw, sp.w_bits) if store == "dense"
          else packing.pack_weights(qw, sp, axis=2))
    k_full = cin if store == "dense" else None
    kw = dict(padding=padding, weight_store=store, k_full=k_full)
    plan = plan_lib.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp,
                                       padding=padding, weight_store=store,
                                       k_full=k_full, device=hopper)
    assert (plan.backend, plan.route) == ("cuda", "tensor_cores")
    assert plan.chunks > 1
    want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)
    ulppack_conv2d.reset_counts()
    got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding=padding)
    assert ulppack_conv2d.kernel_launches["ulppack_conv2d_mma"] == 1
    assert ulppack_conv2d.kernel_launches["ulppack_conv2d"] == 0
    assert torch.equal(got, want)
    if fw <= plan_lib.CONV_FW_MAX:
        core = plan_lib.packed_conv2d_core_geometry(
            tuple(xp.shape), tuple(wp.shape), padding=padding, device=hopper)
        assert torch.equal(
            ulppack_conv2d.ulppack_conv2d_cuda(xp, wp, sp, **core, **kw), want)
    ep = ulppack_conv2d.ConvAffine(
        torch.tensor(4 / 3, device=hopper), torch.tensor(0.0213,
                                                         device=hopper),
        torch.tensor(2, dtype=torch.int32, device=hopper))
    fused = ulppack_conv2d.ulppack_conv2d_mma_cuda(xp, wp, sp, plan=plan,
                                                   epilogue=ep, **kw)
    eager = cnn.conv_epilogue({
        "acc": want, "psum": cnn.patch_sums(qx, fh, fw, padding),
        "a_scale": ep.a_scale, "w_scale": ep.w_scale, "w_zp": ep.w_zp})
    assert torch.equal(fused, eager)


#: The value ranges of the integer conv: Fig. 4's [-256, 256) (within the
#: type), the type's full range (the int16 sums wrap), and every value at
#: the type's minimum.
INT_RANGES = ("fig4", "full", "min")
INT_DTYPES = [(torch.int8, torch.int8), (torch.int8, torch.int16),
              (torch.int16, torch.int8), (torch.int16, torch.int16)]


def _int_values(dev, g, shape, dtype, rng):
    info = torch.iinfo(dtype)
    if rng == "min":
        return torch.full(shape, info.min, dtype=dtype, device=dev)
    lo, hi = ((max(info.min, -256), min(info.max + 1, 256)) if rng == "fig4"
              else (info.min, info.max + 1))
    return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=dtype)


def _int_conv_case(dev, geom, xdtype, wdtype, rng, seed):
    n, h, w, cin, fh, fw, co, padding = geom
    g = _gen(dev, seed)
    qx = _int_values(dev, g, (n, h, w, cin), xdtype, rng)
    qw = _int_values(dev, g, (fh, fw, cin, co), wdtype, rng)
    plan = plan_lib.plan_int_conv2d(
        tuple(qx.shape), tuple(qw.shape), x_bytes=qx.element_size(),
        w_bytes=qw.element_size(), padding=padding, device=dev)
    return qx, qw, plan


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=lambda g: "x".join(
    map(str, g)))
@pytest.mark.parametrize("rng", INT_RANGES)
@pytest.mark.parametrize("xdtype,wdtype", INT_DTYPES,
                         ids=lambda d: str(d).split(".")[-1])
def test_int_conv2d_bit_equal(hopper, xdtype, wdtype, rng, geom):
    """K6 through the planner's route (every CONV_GEOMS shape fits the
    tensor cores) at the four operand types and three value ranges:
    bit-equal to the plain version, one tensor-core launch, no CUDA-core
    launch."""
    padding = geom[-1]
    qx, qw, plan = _int_conv_case(hopper, geom, xdtype, wdtype, rng,
                                  geom[3] * geom[6])
    assert (plan.backend, plan.route) == ("cuda", "tensor_cores")
    ulppack_conv2d.reset_counts()
    got = ops.int_conv2d(qx, qw, padding=padding, plan=plan)
    assert ulppack_conv2d.kernel_launches["int_conv2d_mma"] == 1
    assert ulppack_conv2d.kernel_launches["int_conv2d"] == 0
    assert torch.equal(got, ulppack_conv2d.int_conv2d_torch(
        qx, qw, padding=padding))


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=lambda g: "x".join(
    map(str, g)))
@pytest.mark.parametrize("xdtype,wdtype", INT_DTYPES,
                         ids=lambda d: str(d).split(".")[-1])
def test_int_conv2d_core_tile_bit_equal(hopper, xdtype, wdtype, geom):
    """The CUDA-core K6 with its own geometry forced (shapes the planner
    sends to the tensor cores) stays bit-equal at the full ranges."""
    qx, qw, _ = _int_conv_case(hopper, geom, xdtype, wdtype, "full", 5)
    core = plan_lib.int_conv2d_core_geometry(
        tuple(qx.shape), tuple(qw.shape), padding=geom[-1], device=hopper)
    got = ulppack_conv2d.int_conv2d_cuda(qx, qw, **core, padding=geom[-1])
    assert torch.equal(got, ulppack_conv2d.int_conv2d_torch(
        qx, qw, padding=geom[-1]))


#: (geometry, x dtype, w dtype, route): every shape on the tensor cores --
#: C 32 at 7x7 with the weights resident at every type, C 64 resident only
#: with int8 activations and in channel chunks with int16 ones, a 9x9
#: kernel (past the CUDA-core tile's register window).
INT_ROUTES = [
    ((1, 30, 40, 32, 7, 7, 64, "SAME"), torch.int16, torch.int16,
     "tensor_cores"),
    ((1, 30, 40, 64, 7, 7, 24, "SAME"), torch.int16, torch.int16,
     "tensor_cores"),
    ((1, 30, 40, 64, 7, 7, 24, "SAME"), torch.int16, torch.int8,
     "tensor_cores"),
    ((1, 30, 40, 64, 7, 7, 24, "VALID"), torch.int8, torch.int16,
     "tensor_cores"),
    ((1, 12, 21, 100, 3, 3, 8, "SAME"), torch.int8, torch.int8,
     "tensor_cores"),
    ((2, 19, 23, 5, 9, 9, 17, "SAME"), torch.int16, torch.int16,
     "tensor_cores"),
]


@pytest.mark.parametrize("geom,xdtype,wdtype,route", INT_ROUTES,
                         ids=lambda v: str(v).split(".")[-1])
def test_int_conv2d_route_per_shape(hopper, geom, xdtype, wdtype, route):
    """The planner's route per shape, recorded in the plan and taken by
    ops.int_conv2d (one launch of that kernel); bit-equal either way."""
    qx, qw, plan = _int_conv_case(hopper, geom, xdtype, wdtype, "full", 7)
    assert plan.route == route
    assert plan_lib.int_conv2d_on_tensor_cores(
        tuple(qx.shape), tuple(qw.shape), x_bytes=qx.element_size(),
        w_bytes=qw.element_size(), padding=geom[-1]) is (
            route == "tensor_cores")
    ulppack_conv2d.reset_counts()
    got = ops.int_conv2d(qx, qw, padding=geom[-1])
    name = "int_conv2d_mma" if route == "tensor_cores" else "int_conv2d"
    assert ulppack_conv2d.kernel_launches[name] == 1
    assert sum(ulppack_conv2d.kernel_launches.values()) == 1
    assert sum(ulppack_conv2d.plain_calls.values()) == 0
    assert torch.equal(got, ulppack_conv2d.int_conv2d_torch(
        qx, qw, padding=geom[-1]))


#: (N, H, W, C, Fh, Fw, Co, padding): shapes the tensor-core K6 takes in
#: channel chunks with int16 activations -- Fig. 4 at 64 channels (one tile
#: row), 3x3 over 256 channels at several images, C 65 and 33, a 1x1 conv
#: over 2,048 channels, a 9x9 kernel -- and one tap of 32,897 channels,
#: whose sums fold into the uint32 total once.
K6_WIDE = [(1, 30, 70, 64, 7, 7, 32, "VALID"),
           (5, 14, 14, 256, 3, 3, 40, "SAME"),
           (1, 21, 19, 65, 7, 7, 9, "VALID"),
           (1, 20, 23, 33, 7, 7, 8, "SAME"),
           (2, 16, 40, 2048, 1, 1, 24, "SAME"),
           (1, 19, 23, 128, 9, 9, 17, "SAME"),
           (1, 3, 5, 32897, 1, 1, 8, "VALID")]


@pytest.mark.parametrize("geom", K6_WIDE, ids=lambda g: "x".join(
    map(str, g)))
@pytest.mark.parametrize("rng", INT_RANGES)
@pytest.mark.parametrize("xdtype,wdtype", INT_DTYPES,
                         ids=lambda d: str(d).split(".")[-1])
def test_int_conv2d_mma_chunked_bit_equal(hopper, xdtype, wdtype, rng,
                                          geom):
    """The tensor-core K6 at the wide shapes (channel chunks at int16
    activations; at int8 ones some stay resident), the four operand types
    and three value ranges, the full int16 range included: bit-equal to the
    plain K6 and, where its register window takes the kernel, to the
    CUDA-core tile; one launch."""
    qx, qw, plan = _int_conv_case(hopper, geom, xdtype, wdtype, rng,
                                  geom[3] + geom[6])
    assert plan.route == "tensor_cores"
    assert plan.chunks > 1 or xdtype == torch.int8
    want = ulppack_conv2d.int_conv2d_torch(qx, qw, padding=geom[-1])
    ulppack_conv2d.reset_counts()
    got = ops.int_conv2d(qx, qw, padding=geom[-1], plan=plan)
    assert ulppack_conv2d.kernel_launches["int_conv2d_mma"] == 1
    assert sum(ulppack_conv2d.kernel_launches.values()) == 1
    assert torch.equal(got, want)
    if geom[5] <= plan_lib.CONV_FW_MAX:
        core = plan_lib.int_conv2d_core_geometry(
            tuple(qx.shape), tuple(qw.shape), padding=geom[-1],
            device=hopper)
        assert torch.equal(ulppack_conv2d.int_conv2d_cuda(
            qx, qw, **core, padding=geom[-1]), want)


@pytest.mark.parametrize("xdtype,wdtype", INT_DTYPES,
                         ids=lambda d: str(d).split(".")[-1])
def test_int_conv2d_mma_repeats(hopper, xdtype, wdtype):
    """Two launches of the tensor-core K6 and a CUDA-graph replay of one
    are bit-equal to the plain version at the full ranges."""
    geom = (1, 37, 45, 32, 7, 7, 24, "SAME")
    qx, qw, plan = _int_conv_case(hopper, geom, xdtype, wdtype, "full", 11)
    assert plan.route == "tensor_cores"
    want = ulppack_conv2d.int_conv2d_torch(qx, qw, padding="SAME")

    def call():
        return ulppack_conv2d.int_conv2d_mma_cuda(qx, qw, plan=plan,
                                                  padding="SAME")

    assert torch.equal(call(), want) and torch.equal(call(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("change", [
    dict(block_w=64), dict(block_h=8), dict(block_co=32), dict(block_c=32),
    dict(stages=3), dict(threads=128), dict(blocks=0), dict(blocks=1000),
    dict(smem_bytes=16), dict(chunk_c=32), dict(chunks=2),
    dict(chunk_c=32, chunks=2)])
def test_int_conv2d_mma_launcher_refuses_a_plan_that_disagrees(hopper,
                                                               change):
    """A plan whose tile, channel block, staged bytes, ring, threads, block
    count or shared memory disagrees with the tensor-core K6's
    layout is refused by the launcher and raises (smem_bytes moves by the
    amount given; the other fields are set); so is, in the wrapper, a plan
    made for other operand widths or the other route."""
    import dataclasses

    geom = (1, 40, 37, 32, 7, 7, 24, "SAME")
    qx, qw, plan = _int_conv_case(hopper, geom, torch.int16, torch.int16,
                                  "fig4", 3)
    bad = dataclasses.replace(plan, **{
        f: plan.smem_bytes + v if f == "smem_bytes" else v
        for f, v in change.items()})
    assert torch.equal(
        ulppack_conv2d.int_conv2d_mma_cuda(qx, qw, plan=plan, padding="SAME"),
        ulppack_conv2d.int_conv2d_torch(qx, qw, padding="SAME"))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ulppack_conv2d.int_conv2d_mma_cuda(qx, qw, plan=bad, padding="SAME")
    with pytest.raises(ValueError, match="tensor_cores"):
        ulppack_conv2d.int_conv2d_mma_cuda(qx.to(torch.int8), qw, plan=plan,
                                           padding="SAME")
    with pytest.raises(ValueError, match="tensor_cores"):
        ulppack_conv2d.int_conv2d_mma_cuda(
            qx, qw, plan=dataclasses.replace(plan, route="cuda_cores"),
            padding="SAME")


@pytest.mark.parametrize("field", ["threads", "smem_bytes"])
def test_conv_launcher_refuses_a_plan_that_disagrees_with_the_tile(hopper,
                                                                   field):
    import dataclasses

    qx = torch.zeros((1, 9, 9, 4), dtype=torch.int16, device=hopper)
    qw = torch.zeros((3, 3, 4, 8), dtype=torch.int16, device=hopper)
    plan = plan_lib.plan_int_conv2d(tuple(qx.shape), tuple(qw.shape),
                                    x_bytes=2, w_bytes=2, device=hopper)
    # the CUDA-core tile's route, with its geometry for these shapes
    plan = dataclasses.replace(plan, route="cuda_cores", **(
        plan_lib.int_conv2d_core_geometry(tuple(qx.shape), tuple(qw.shape),
                                          device=hopper)))
    assert torch.equal(ops.int_conv2d(qx, qw, plan=plan),
                       torch.zeros((1, 7, 7, 8), dtype=torch.int32,
                                   device=hopper))
    bad = dataclasses.replace(plan, **{field: getattr(plan, field) + 4})
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.int_conv2d(qx, qw, plan=bad)


@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_paged_attention_matches_plain_and_contiguous(hopper, kv_bits, c,
                                                      shape):
    """K4 against the paged plain version (1e-4, as K3) and against K3 on
    the same logical rows laid out contiguously: bit-equal.  The dead row is
    exactly zero."""
    q, cache, pool, bt, vl, qpos, hd = _attn_case(hopper, kv_bits, c, shape,
                                                  kv_bits + c)
    got = ulppack_attention.attention_decode_paged_cuda(
        q, pool, vl, qpos, bt, kv_bits=kv_bits, hd=hd)
    want = ulppack_attention.attention_decode_torch(
        q, pool, vl, qpos, kv_bits=kv_bits, hd=hd, block_k=64,
        block_tables=bt)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    k3 = ulppack_attention.attention_decode_cuda(q, cache, vl, qpos,
                                                 kv_bits=kv_bits, hd=hd)
    assert torch.equal(got, k3)
    assert not got[2].any()


INT_MM_TYPES = [(torch.int8, torch.int8), (torch.int16, torch.int16),
                (torch.int8, torch.int16), (torch.int16, torch.int8)]


def _int_mm_plan(m, k, n, da, dw, dev):
    return plan_lib.plan_int_matmul(m, k, n, a_bytes=da.itemsize,
                                    w_bytes=dw.itemsize, device=dev)


@pytest.mark.parametrize("m,k,n", [(1, 7, 3), (5, 600, 130), (130, 600, 70),
                                   (8, 4096, 4096), (64, 4096, 4096),
                                   (9, 1000, 70), (17, 333, 4097),
                                   (1, 4096, 4097)])
@pytest.mark.parametrize("da,dw", INT_MM_TYPES)
def test_int_matmul_bit_equal(hopper, m, k, n, da, dw):
    """K7 against its plain version, bit-equal, over the full operand
    ranges (int16 sums wrap mod 2^32), at M that fills no 8-row group and
    N that is no multiple of the tile or of the copy size."""
    g = _gen(hopper, m + k + n)

    def draw(shape, dt):
        info = torch.iinfo(dt)
        return torch.randint(info.min, info.max + 1, shape, generator=g,
                             device=hopper, dtype=dt)

    a, w = draw((m, k), da), draw((k, n), dw)
    plan = _int_mm_plan(m, k, n, da, dw, hopper)
    assert plan.backend == "cuda"
    got = ops.int_matmul(a, w, plan=plan)
    assert torch.equal(got, ulppack_matmul.int_matmul_torch(a, w))


@pytest.mark.parametrize("da,dw", INT_MM_TYPES)
def test_int_matmul_long_k_at_extremes(hopper, da, dw):
    """K = 40,000 with operands drawn from {min, max, -1} (-1 and max have
    a low byte of 255, the worst byte-plane sums): bit-equal with the
    planner's splits and with the longest split the kernel takes (32768),
    the int16 sums wrapping; two launches bit-equal."""
    import dataclasses

    m, k, n = 9, 40000, 70
    g = _gen(hopper, 7)

    def draw(shape, dt):
        info = torch.iinfo(dt)
        vals = torch.tensor([info.min, info.max, -1], dtype=dt,
                            device=hopper)
        return vals[torch.randint(0, 3, shape, generator=g, device=hopper)]

    a, w = draw((m, k), da), draw((k, n), dw)
    want = ulppack_matmul.int_matmul_torch(a, w)
    plan = _int_mm_plan(m, k, n, da, dw, hopper)
    longest = dataclasses.replace(
        plan, block_k=plan_lib.INT_MATMUL_MAX_BLOCK_K, splits=2)
    runs = [ops.int_matmul(a, w, plan=p) for p in (plan, plan, longest)]
    assert all(torch.equal(r, want) for r in runs)


@pytest.mark.parametrize("change", [
    dict(block_n=64), dict(step_k=32), dict(stages=3), dict(threads=128),
    dict(block_m=24), dict(block_m=16), dict(smem_bytes=16),
    dict(splits=1), dict(block_k=32832, splits=None), "int16 operands"])
def test_int_matmul_launcher_refuses_a_plan_that_disagrees(hopper, change):
    """A plan whose tile, shared memory, split count or split length
    (above 32768) disagrees with the kernel's layout, or that was made for
    other operand sizes, is refused by the launcher and raises.
    (smem_bytes and splits move by the amount given, None sets splits to
    1; the other fields are set.)"""
    import dataclasses

    m, k, n = 8, 600, 70
    a = torch.ones((m, k), dtype=torch.int8, device=hopper)
    w = torch.ones((k, n), dtype=torch.int8, device=hopper)
    plan = _int_mm_plan(m, k, n, torch.int8, torch.int8, hopper)
    if change == "int16 operands":
        a = a.to(torch.int16)
        good, bad = _int_mm_plan(m, k, n, a.dtype, w.dtype, hopper), plan
    else:
        def moved(f, v):
            if f == "splits":
                return 1 if v is None else plan.splits + v
            return plan.smem_bytes + v if f == "smem_bytes" else v
        good = plan
        bad = dataclasses.replace(plan, **{f: moved(f, v)
                                           for f, v in change.items()})
    assert torch.equal(ops.int_matmul(a, w, plan=good),
                       ulppack_matmul.int_matmul_torch(a, w))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.int_matmul(a, w, plan=bad)
