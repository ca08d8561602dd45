"""K2 on the int8 tensor cores (``csrc/ulppack_matmul_mma.cu``) from the CPU:
the planner's route by layout and its geometry at every K2 shape of
full-width ``stablelm-1.6b`` serving, the planner's constants against the
kernel's source, a plain emulation of the kernel's byte-plane arithmetic
against ``repro``'s Pallas ``ulppack_matmul`` (interpret mode) and the
port's packed-lane matmul, a plain emulation of its fused epilogue in the
kernel's operation order against ``ops.quantized_linear``, and the CUDA
wrappers' refusals.  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py -k ulppack_matmul``)."""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ulppack_matmul as jmm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import quant_pack as tqp  # noqa: E402
from repro_torch.kernels import ulppack_matmul as tmm  # noqa: E402

torch.set_num_threads(2)

SPEC = PackSpec(2, 2)          # int16xP2s8, the shipped W2A2 layout


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
    """Pin the reference's per-layer layout to the base spec: an empty
    tuning cache, so reports/autotune_cpu.json cannot pick another."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

def _main_path_shapes():
    """(rows, Kp, N) of every K2 call of full-width stablelm-1.6b serving:
    q/k/v/o, gate/up and down at the decode rows (max_batch 4) and the
    chunked-prefill rows (4 x prefill_chunk 16)."""
    cfg = configs.get_config("stablelm-1.6b")
    d, f = cfg.d_model, cfg.d_ff
    mats = {(d, cfg.num_heads * (d // cfg.num_heads)), (d, f), (f, d)}
    return sorted((rows, -(-k // 2), n) for rows in (4, 4 * 16)
                  for k, n in mats)


def test_main_path_shapes_are_the_five_k2_rows():
    assert _main_path_shapes() == [
        (4, 1024, 2048), (4, 1024, 5632), (4, 2816, 2048),
        (64, 1024, 2048), (64, 1024, 5632), (64, 2816, 2048)]


#: (block_m, splits) the planner picks at the main path's shapes: the
#: fastest, or within 6 % of it, in the split sweep of ``chip_smoke.py
#: --k2-sweep`` on an H100 (PERF.md).
MAIN_PATH_GEOMETRY = {(4, 1024, 2048): (8, 8), (4, 1024, 5632): (8, 3),
                      (4, 2816, 2048): (8, 8), (64, 1024, 2048): (32, 4),
                      (64, 1024, 5632): (64, 3), (64, 2816, 2048): (32, 4)}


@pytest.mark.parametrize("m,kp,n", _main_path_shapes(),
                         ids=lambda v: str(v))
def test_tensor_core_geometry_on_the_main_path(m, kp, n):
    """int16xP2s8 takes the tensor-core tile: rows in blocks of 8 (decode)
    or 32 / 64 (prefill), 128 columns, 64-lane stages through the tile's
    ring and shared memory, K in whole stages split so that the blocks
    fill one wave of the card's 132 SMs, each split at most 16384
    lanes."""
    p = tplan.plan_packed_matmul(m, kp, n, SPEC, weight_store="lanes")
    assert p.op == "packed_matmul" and p.backend == "torch"
    assert (p.block_m, p.splits) == MAIN_PATH_GEOMETRY[(m, kp, n)]
    assert (p.block_n, p.step_k, p.threads) == (
        tplan.INT_MATMUL_BN, tplan.INT_MATMUL_BK, tplan.INT_MATMUL_THREADS)
    assert (p.stages, p.smem_bytes) == tplan.int_matmul_smem_layout(
        p.block_m, 2, 2)
    assert p.smem_bytes <= tplan.INT_MATMUL_SMEM_MAX
    assert p.block_k % tplan.INT_MATMUL_BK == 0
    assert tplan.INT_MATMUL_BK <= p.block_k <= tplan.ULPPACK_MMA_MAX_BLOCK_K
    assert p.splits == -(-kp // p.block_k) >= 2
    blocks = -(-n // 128) * -(-m // p.block_m) * p.splits
    assert blocks <= 132


@pytest.mark.parametrize("text,raw_lanes", [
    ("W2A2/int16xP2s8", True), ("W1A1/int16xP2s8", True),
    ("W3A3/int16xP2s8", True), ("W1A1/int16xP4s4", False),
    ("W1A1/int8xP2s4", False), ("W2A2/int32xP2s16", False),
    ("W2A2/int32xP4s8", False), ("W2A2/int32xP2s8", False)])
def test_route_by_layout(text, raw_lanes):
    """Every feasible layout goes to the tensor cores.  int16 lanes of two
    byte fields split into planes as they are (``raw_lanes``: RawW<2>,
    csrc/ulppack_matmul_mma.cu); every other layout's fields are written
    to the same plane bytes as they are staged (LanesW / LanesA, its own
    library of csrc/ulppack_matmul_mma_lanes.cu).  The plan is the tile's
    over K = Kp n_pack / 2 steps of two values, with the layout's raw
    lane tile in the ring."""
    sp = PackSpec.parse(text)
    assert tplan.packed_matmul_on_tensor_cores(sp)
    p = tplan.plan_packed_matmul(4, 1024, 2048, sp, weight_store="lanes")
    assert p.block_n == 128 and p.step_k == 64 and p.stages is not None
    k = tplan.mma_k(1024, sp)
    assert k == 1024 * sp.n_pack // 2
    assert (p.stages, p.smem_bytes) == tplan.int_matmul_smem_layout(
        p.block_m, tplan.mma_a_bytes(sp), 2,
        w_tile=tplan.lanes_w_tile_bytes(sp), a_planes=2)
    assert (p.splits - 1) * p.block_k < k <= p.splits * p.block_k
    assert (build.layout_library(sp) == "ulppack_matmul_mma") is raw_lanes


@pytest.mark.parametrize("m,kp,n", [(1, 40000, 70), (4, 100000, 128),
                                    (64, 1 << 20, 4096), (9, 16385, 8)])
def test_split_cap(m, kp, n):
    """No split holds more than 16384 lanes (32,768 lattice values), so
    no s32 MMA sum leaves range even at fields of 255; the splits cover
    Kp with none empty."""
    p = tplan.plan_packed_matmul(m, kp, n, SPEC, weight_store="lanes")
    assert p.block_k <= tplan.ULPPACK_MMA_MAX_BLOCK_K
    assert 2 * p.block_k <= 32768 and 255 * 255 * 32768 < 2**31
    assert 2 * 255 * 255 * 2 * tplan.ULPPACK_MMA_MAX_BLOCK_K >= 2**31
    assert (p.splits - 1) * p.block_k < kp <= p.splits * p.block_k


def test_constants_match_the_kernel_source():
    """The planner's copy of the tensor-core K2's geometry is the one in
    csrc/mma_s8.cuh (the tile) and csrc/ulppack_matmul_mma.cu (the split
    cap, the block_m cases, the 2-byte operands)."""
    csrc = Path(tplan.__file__).parent.parent / "csrc"
    tile = (csrc / "mma_s8.cuh").read_text()
    src = (csrc / "ulppack_matmul_mma.cu").read_text() \
        + (csrc / "ulppack_matmul_mma.cuh").read_text()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", tile + src)}
    assert (c["kBN"], c["kBK"], c["kMaxStages"], c["kSmemMax"],
            c["kThreads"], c["kMaxBlockK"]) == (
        tplan.INT_MATMUL_BN, tplan.INT_MATMUL_BK, tplan.INT_MATMUL_MAX_STAGES,
        tplan.INT_MATMUL_SMEM_MAX, tplan.INT_MATMUL_THREADS,
        tplan.ULPPACK_MMA_MAX_BLOCK_K)
    assert "constexpr int kPlaneRow = kBK + 16;" in tile
    cases = tuple(int(v) for v in
                  re.findall(r"case (\d+): return launch_variant", src))
    assert cases == tplan.INT_MATMUL_BLOCK_MS
    # lanes are staged at 2 bytes a lane (x at 2 x its element size), and
    # W's lanes are 2-byte (the W side RawW<2>: a [64, 128] int16 tile, two
    # planes); the ring and shared memory follow the W side's tile
    assert "const int ab = xb ? 2 * xb : LA::kBytes;" in src
    assert "static constexpr int kBytes = AB;" in tile
    assert "smem_bytes_w(block_m, ab, WS::kTile, WS::kPlanes, 2)" in src
    assert "mainloop_w<WS, BM, V16>" in src
    assert "launch_mma<RawW<2>>" in src
    assert "static constexpr int kTile = kBK * kBN * WB;" in tile


# ---------------------------------------------------------------------------
# The kernel's arithmetic
# ---------------------------------------------------------------------------

def mma_emulation(a, w, block_k):
    """The tensor-core K2 in plain torch: the int16 lanes as u8 byte planes
    (lo = x & 0xFF, hi = x >> 8 & 0xFF), per K split of ``block_k`` lanes
    one s32 sum of W's hi plane x a's lo plane plus W's lo x a's hi --
    held to the int32 range the MMA accumulator has -- and the splits
    added in order mod 2^32."""
    a64, w64 = a.to(torch.int64), w.to(torch.int64)
    lo_a, hi_a = a64 & 0xFF, (a64 >> 8) & 0xFF
    lo_w, hi_w = w64 & 0xFF, (w64 >> 8) & 0xFF
    total = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64)
    for k0 in range(0, a.shape[1], block_k):
        s = slice(k0, k0 + block_k)
        part = lo_a[:, s] @ hi_w[s] + hi_a[:, s] @ lo_w[s]
        assert 0 <= int(part.min()) and int(part.max()) < 2**31
        total = (total + part) & 0xFFFFFFFF
    return tpack.wrap_i32(total)


@pytest.mark.parametrize("m", [1, 4, 9, 64])
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_byte_plane_dot_equals_reference(bits, m):
    """At W1A1, W2A2 and W3A3 on int16xP2s8, Kp = 100 (no multiple of 64)
    and N = 200 (no multiple of 128): the emulation with the planner's
    splits, with splits of one stage (two) and with one split equals
    repro's Pallas
    ulppack_matmul (interpret mode) and the port's packed-lane matmul."""
    js = jpack.PackSpec.parse(f"W{bits}A{bits}/int16xP2s8")
    ts = PackSpec.parse(str(js))
    kp, n = 100, 200
    rng = np.random.default_rng(bits * 100 + m)
    qa = rng.integers(0, js.max_a + 1, (m, 2 * kp)).astype(np.int32)
    qw = rng.integers(0, js.max_w + 1, (2 * kp, n)).astype(np.int32)
    ja = jpack.pack_activations(jnp.asarray(qa), js)
    jw = jpack.pack_weights(jnp.asarray(qw), js)
    want = np.asarray(jmm.ulppack_matmul(
        ja, jw, js, block_m=-(-m // 8) * 8, block_n=256,
        chunks=-(-kp // js.k_tile), interpret=True))
    a = torch.from_numpy(np.array(ja))
    w = torch.from_numpy(np.array(jw))
    np.testing.assert_array_equal(
        tpack.packed_lanes_matmul(a, w, ts).numpy(), want)
    np.testing.assert_array_equal(want, qa @ qw)
    p = tplan.plan_packed_matmul(m, kp, n, ts, weight_store="lanes")
    for block_k in (p.block_k, 64, tplan.ULPPACK_MMA_MAX_BLOCK_K):
        np.testing.assert_array_equal(mma_emulation(a, w, block_k).numpy(),
                                      want)


def test_byte_plane_dot_at_the_split_cap():
    """Lanes of 0xFFFF (both bytes 255) over Kp = 40,000: each split of
    16384 lanes stays in int32, the total wraps mod 2^32 like the exact
    int64 sum of the byte products."""
    a = torch.full((2, 40000), -1, dtype=torch.int16)
    w = torch.full((40000, 3), -1, dtype=torch.int16)
    got = mma_emulation(a, w, tplan.ULPPACK_MMA_MAX_BLOCK_K)
    exact = 2 * 255 * 255 * 40000
    assert exact > 2**32
    assert torch.equal(got, tpack.wrap_i32(torch.full((2, 3), exact)))


# ---------------------------------------------------------------------------
# The fused epilogue
# ---------------------------------------------------------------------------

def affine_emulation(acc, ep: tmm.Affine):
    """The kernel's epilogue in plain torch, one f32 operation at a time in
    its order: s = a_scale * w_scale; kzz = (k * a_zp) * w_zp; per element
    (((acc - w_zp * a_sum) - a_zp * col_sum) + kzz) * s [+ bias], then
    rounded to the output dtype."""
    f32 = torch.float32
    s = torch.as_tensor(ep.a_scale).to(f32) * torch.as_tensor(
        ep.w_scale).to(f32)
    azp = torch.as_tensor(ep.a_zp).to(f32)
    wzp = torch.as_tensor(ep.w_zp).to(f32)
    kzz = (torch.tensor(float(ep.k), dtype=f32) * azp) * wzp
    c = acc.to(f32) - wzp * ep.a_sums.reshape(-1, 1).to(f32)
    c = c - azp * ep.col_sums.reshape(1, -1).to(f32)
    c = c + kzz
    v = s * c
    if ep.bias is not None:
        v = v + ep.bias.reshape(1, -1).to(f32)
    return v.to(ep.out_dtype)


def _linear_case(m, k, n, bias_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=g) * 0.05
    zp = torch.tensor(2, dtype=torch.int32)
    w_scale = torch.tensor(0.021)
    a_scale = torch.tensor(0.37)
    wp, cs = ops.prepare_weights(w, w_scale, zp, SPEC)
    bias = None if bias_dtype is None else (
        torch.randn((n,), generator=g).to(bias_dtype))
    x = torch.randn((m, k), generator=g) * 1.5
    return x, wp, cs, a_scale, zp, w_scale, zp, bias


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32,
                                        torch.bfloat16])
def test_epilogue_emulation_bit_equal_to_quantized_linear(out_dtype,
                                                          bias_dtype):
    """The epilogue in the kernel's order equals the eager correction of
    ops.quantized_linear ('torch' backend) bit for bit, in f32 and bf16,
    with and without bias, on the emulated tensor-core dot."""
    m, k, n = 9, 203, 200          # odd K: a padded lane
    x, wp, cs, a_scale, a_zp, w_scale, w_zp, bias = _linear_case(
        m, k, n, bias_dtype, 1)
    want = ops.quantized_linear(x, wp, cs, a_scale, a_zp, w_scale, w_zp,
                                SPEC, bias=bias, out_dtype=out_dtype)
    a, a_sums = ops.quantize_pack(x, a_scale, a_zp, SPEC)
    acc = mma_emulation(a, wp, tplan.plan_packed_matmul(
        m, a.shape[1], n, SPEC, weight_store="lanes").block_k)
    got = affine_emulation(acc, tmm.Affine(a_sums, cs, a_scale, a_zp,
                                           w_scale, w_zp, k, bias,
                                           out_dtype))
    assert got.dtype == out_dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 6])
def test_epilogue_emulation_within_tolerance_of_repro(base_layouts, rows):
    """Against repro's quantized_linear ('xla'): the same 1e-5 relative and
    absolute tolerance as the eager path's parity test (same lattice, same
    correction; only f32 rounding order may differ), with a bias."""
    k, n = 40, 24
    x, wp, cs, a_scale, a_zp, w_scale, w_zp, bias = _linear_case(
        rows, k, n, torch.float32, rows)
    js = jpack.PackSpec.parse(str(SPEC))
    want = np.asarray(jops.quantized_linear(
        jnp.asarray(x.numpy()), jnp.asarray(wp.numpy()),
        jnp.asarray(cs.numpy()), jnp.asarray(a_scale.numpy()),
        jnp.asarray(a_zp.numpy()), jnp.asarray(w_scale.numpy()),
        jnp.asarray(w_zp.numpy()), js, bias=jnp.asarray(bias.numpy()),
        backend="xla"))
    a, a_sums = ops.quantize_pack(x, a_scale, a_zp, SPEC)
    acc = mma_emulation(a, wp, 64)
    got = affine_emulation(acc, tmm.Affine(a_sums, cs, a_scale, a_zp,
                                           w_scale, w_zp, k, bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_quantized_linear_takes_the_fused_route_on_cuda_plans(monkeypatch,
                                                              lead):
    """With a 'cuda' plan on int16xP2s8 (the fused route's),
    ops.quantized_linear makes one call of the tensor-core K2 with K1
    folded in (here a stand-in that emulates it on the CPU: the plain K1
    on x.float(), the byte-plane dot, the epilogue), hands it x in its
    own dtype with no K1 call of its own, and returns its output in the
    input's leading shape: the eager correction does not run."""
    k, n = 50, 24
    x, wp, cs, a_scale, a_zp, w_scale, w_zp, bias = _linear_case(
        6, k, n, torch.bfloat16, 5)
    x = x.to(torch.bfloat16).reshape(*lead, k)
    want = ops.quantized_linear(x, wp, cs, a_scale, a_zp, w_scale, w_zp,
                                SPEC, bias=bias, out_dtype=torch.bfloat16)
    calls = []

    def stand_in(x2, w, col_sums, a_scale, a_zp, w_scale, w_zp, spec, *,
                 plan, bias, out_dtype):
        calls.append((x2.dtype, tuple(x2.shape), plan))
        a, a_sums = tqp.quantize_pack_torch(x2.float(), a_scale, a_zp, spec)
        return affine_emulation(mma_emulation(a, w, plan.block_k), tmm.Affine(
            a_sums, col_sums, a_scale, a_zp, w_scale, w_zp, plan.k_full, bias,
            out_dtype))

    def no_k1(*args, **kwargs):
        raise AssertionError("K1 called on the fused route")

    monkeypatch.setattr(tmm, "quantized_linear_mma_cuda", stand_in)
    monkeypatch.setattr(ops, "quantize_pack", no_k1)
    plan = tplan._plan_quantized_linear(6, k, n, SPEC, 2, "cpu", "lanes")
    assert (plan.op, plan.backend, plan.k_full) == ("quantized_linear",
                                                    "cuda", k)
    got = ops.quantized_linear(x, wp, cs, a_scale, a_zp, w_scale, w_zp,
                               SPEC, bias=bias, plan=plan,
                               out_dtype=torch.bfloat16)
    assert calls == [(torch.bfloat16, (6, k), plan)]
    assert got.shape == (*lead, n) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# Refusals and counts
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    sp32 = PackSpec(2, 2, "int32", 2, 16)
    a = torch.zeros((4, 8), dtype=torch.int16)
    w = torch.zeros((8, 16), dtype=torch.int16)
    plan = tplan.plan_packed_matmul(4, 8, 16, SPEC, weight_store="lanes")
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.ulppack_matmul_mma_cuda(a, w, SPEC, plan=plan)
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.ulppack_matmul_cuda(a, w, SPEC, block_m=8, block_k=64,
                                splits=1)
    with pytest.raises(ValueError, match="int16xP2s8"):
        tmm.ulppack_matmul_mma_cuda(a.int(), w.int(), sp32, plan=plan)
    with pytest.raises(TypeError, match="packed to int16"):
        tmm.ulppack_matmul_mma_cuda(a.int(), w, SPEC, plan=plan)
    with pytest.raises(ValueError, match="CUDA"):
        ops.quantized_linear(torch.zeros((4, 16)), w, torch.zeros(
            16, dtype=torch.int32), 1.0, 2, 1.0, 2, SPEC, backend="cuda")


def test_cpu_path_counts_plain_calls_only():
    x, wp, cs, a_scale, a_zp, w_scale, w_zp, bias = _linear_case(
        4, 64, 24, None, 2)
    tmm.reset_counts()
    ops.quantized_linear(x, wp, cs, a_scale, a_zp, w_scale, w_zp, SPEC)
    assert tmm.mma_launches == {"s32": 0, "affine": 0, "quant_affine": 0}
    assert tmm.kernel_launches["ulppack_matmul"] == 0
    assert tmm.plain_calls["ulppack_matmul"] == 1
