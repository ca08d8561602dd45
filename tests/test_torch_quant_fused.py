"""K1 folded into the tensor-core K2 (``csrc/ulppack_matmul_mma.cu`` with
the ``QuantA`` side of ``csrc/mma_s8.cuh``): ``ops.quantized_linear`` at
``int16xP2s8`` on the card is one launch that reads the float activations
in their own dtype.  On the CPU: the fused planner's geometry against the
kernel's sources, a plain emulation of the kernel's prologue (stage by
stage quantize into byte planes, row sums per split, splits in order)
against K1's plain version and the packed-lane dot, the port's plain route
on f32 / bf16 / f16 activations against ``repro``'s ``quantized_linear``,
and the routing by layout with the CUDA wrappers stood in.  The tests
marked ``cuda`` run the kernels on a Hopper card and skip elsewhere
(the card's machine has no JAX: only the reference test imports it):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_quant_fused.py
"""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import quant_pack as tqp  # noqa: E402
from repro_torch.kernels import ulppack_matmul as tmm  # noqa: E402
from repro_torch.models import common  # noqa: E402

torch.set_num_threads(2)

SPEC = PackSpec(2, 2)          # int16xP2s8, the shipped W2A2 layout
X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
CSRC = Path(tplan.__file__).parent.parent / "csrc"
#: (rows, lattice K, N) of every packed linear of full-width stablelm-1.6b
#: serving: q/k/v/o, gate/up and down at the decode rows (max_batch 4) and
#: the chunked-prefill rows (4 x prefill_chunk 16).
MAIN_PATH = ((4, 2048, 2048), (4, 2048, 5632), (4, 5632, 2048),
             (64, 2048, 2048), (64, 2048, 5632), (64, 5632, 2048))


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
    from repro.kernels import autotune

    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def fused_plan(m, k, n, x_dtype, spec=SPEC):
    """The fused route's plan as the planner makes it for the card (its
    geometry does not depend on the card but its SM count, 132 off it)."""
    return tplan._plan_quantized_linear(m, k, n, spec, x_dtype.itemsize,
                                        "cpu", "lanes")


# ---------------------------------------------------------------------------
# (a) The planner
# ---------------------------------------------------------------------------

#: (block_m, stages a split, splits) of the fused route at the main path's
#: shapes (Kp = K / 2): the fastest in the ``k2-sweep-fused`` lines of
#: ``chip_smoke.py --k2-sweep`` on an H100, or within 3 % of it (PERF.md);
#: the lanes route's, but 32 rows for 64 at (64, 1024, 5632).
FUSED_GEOMETRY = {(4, 1024, 2048): (8, 2, 8), (4, 1024, 5632): (8, 6, 3),
                  (4, 2816, 2048): (8, 6, 8), (64, 1024, 2048): (32, 4, 4),
                  (64, 1024, 5632): (32, 16, 1), (64, 2816, 2048): (32, 11, 4)}


@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n", MAIN_PATH, ids=str)
def test_fused_plan_geometry(m, k, n, x_dtype):
    """The fused route's rows and K splits (splits of at most 16384 lanes)
    at the main path's shapes, and its ring sized for float rows: a stage holds
    64 lanes of W (16 KB) and 2 x 64 values of each of block_m rows of x (+16
    bytes), beside two buffers of W's and a's byte planes; with the
    kernel's static shared memory (a row sum per row, a flag) it fits
    the block's 227 KB."""
    p = fused_plan(m, k, n, x_dtype)
    kp = -(-k // 2)
    assert (p.op, p.backend, p.k_full, p.x_bytes) == (
        "quantized_linear", "cuda", k, x_dtype.itemsize)
    assert (p.block_m, p.block_k // 64, p.splits) == FUSED_GEOMETRY[
        (m, kp, n)]
    assert (p.block_n, p.step_k, p.threads) == (128, 64, 256)
    assert p.block_k <= tplan.ULPPACK_MMA_MAX_BLOCK_K
    assert (p.splits - 1) * p.block_k < kp <= p.splits * p.block_k
    row = 2 * 64 * x_dtype.itemsize + 16
    stage = 64 * 128 * 2 + p.block_m * row
    planes = 2 * 128 * 80 + 2 * p.block_m * 80
    assert p.stages == min(8, (232448 - 2 * planes) // stage) >= 3
    assert p.smem_bytes == p.stages * stage + 2 * planes
    assert p.smem_bytes + 4 * (p.block_m + 1) <= 232448
    assert (p.stages, p.smem_bytes) == tplan.int_matmul_smem_layout(
        p.block_m, 2 * x_dtype.itemsize, 2)


def test_fused_plan_ring_depths():
    """bf16 rows at 64 rows a block fit 5 ring stages (6 for lanes), f32
    rows 3; at 8 rows every dtype keeps the full 8."""
    depth = {(bm, xb): tplan.int_matmul_smem_layout(bm, 2 * xb, 2)[0]
             for bm in (8, 64) for xb in (2, 4)}
    assert depth == {(8, 2): 8, (8, 4): 8, (64, 2): 5, (64, 4): 3}
    assert tplan.int_matmul_smem_layout(64, 2, 2)[0] == 6


@pytest.mark.parametrize("text", ["W2A2/int16xP2s8", "W2A2/int32xP2s16",
                                  "W1A1/int16xP4s4", "W1A1/int8xP2s4"])
def test_planner_routes_by_backend_and_layout(text):
    """Off the card, and for every layout but int16xP2s8, the planner
    hands back the packed matmul's plan (K1, K2 and the eager epilogue
    apart); the fused planner refuses a dtype the kernel does not read."""
    sp = PackSpec.parse(text)
    p = tplan.plan_quantized_linear(4, 2048, 2048, sp, torch.bfloat16,
                                    weight_store="lanes")
    assert p is tplan.plan_packed_matmul(4, -(-2048 // sp.n_pack), 2048, sp,
                                         weight_store="lanes")
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tplan._x_bytes(torch.float64)


def test_fused_constants_match_the_kernel_source():
    """The planner's and the wrappers' copies of the fused route's layout
    are the sources': QuantA stages two values of its type a lane, the
    ring row and the plane buffers follow the staged bytes, the launcher's
    a_kind codes and K1's x_kind codes match the wrappers', and both
    quantize with an IEEE divide (no reciprocal) and rint."""
    tile = (CSRC / "mma_s8.cuh").read_text()
    src = (CSRC / "ulppack_matmul_mma.cu").read_text() \
        + (CSRC / "ulppack_matmul_mma.cuh").read_text()
    k1 = (CSRC / "quant_pack.cu").read_text()
    assert ("static constexpr int kBytes = 2 * static_cast<int>(sizeof(T));"
            in tile)
    assert "return kBK * ab + 16;" in tile
    assert "(ap >= 2 ? 2 * bm * kPlaneRow : 0)" in tile
    kinds = {k: int(v) for k, v in re.findall(r"(kX\w+) = (\d)", src)}
    assert kinds == {"kXF32": tmm._X_KINDS[torch.float32],
                     "kXBF16": tmm._X_KINDS[torch.bfloat16],
                     "kXF16": tmm._X_KINDS[torch.float16]}
    for name, t in (("kXF32", "float"), ("kXBF16", "__nv_bfloat16"),
                    ("kXF16", "__half")):
        assert re.search(
            rf"case {name}:\s*return launch_bm<WS, QuantA<{t}>", src)
    for t, code in (("float", 0), ("__nv_bfloat16", 1), ("__half", 2)):
        assert re.search(rf"case {code}:\s*err = launch_x<{t}>", k1)
    assert tqp.X_KINDS == {torch.float32: 0, torch.bfloat16: 1,
                           torch.float16: 2}
    assert "rintf(__fdiv_rn(to_f32(xr[col]), scale)) + zp" in k1
    # the fused quantize: the filter emulated by filtered_quantize below,
    # K1's arithmetic for what it sends on, and the tail forced to 0
    for text in ("inv = __fdiv_rn(1.0f, scale);",
                 "zpi = min(max(*p.a_zp, -(1 << 22)), 1 << 22);",
                 "fast = isfinite(inv) && fabsf(inv) >= 0x1p-126f;",
                 "const float t = __fmul_rn(x, inv);",
                 "const float y = __fadd_rn(t, 0x1.8p23f);",
                 "const float d = __fsub_rn(t, __fsub_rn(y, 0x1.8p23f));",
                 "undecided = !(__fmaf_rn(fabsf(t), 0x1p-21f, fabsf(d))"
                 " < 0.5f);",
                 "__float_as_uint(y) - 0x4B400000u"
                 " + static_cast<uint32_t>(zpi)",
                 "return min(max(n, 0), qmax);",
                 "fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, scale)), zp),"
                 " 0.0f), qmaxf)",
                 "if (u[j] || !fast) q[j] = k1_quantize(v[j]);",
                 "base + j < k_full"):
        assert text in tile, text


# ---------------------------------------------------------------------------
# (b) The kernel's prologue in plain torch
# ---------------------------------------------------------------------------

def quant_mma_emulation(x, w, scale, zp, spec, block_k, block_m):
    """The fused kernel's integer core in plain torch, as it runs: x [M, K]
    staged in whole 64-lane stages and block_m-row blocks (zeros past K and
    past M, as the ring holds them), quantized with K1's arithmetic on its
    f32 values, lattice values past K forced to 0, into the lo plane (even
    lattice index) and the hi plane (odd); W's int16 lanes as byte planes;
    per K split of ``block_k`` lanes an s32 dot of W's hi plane x a's lo
    plus W's lo x a's hi (held to the int32 range the MMA accumulator has)
    and the row sums of the split's values; the splits added in order,
    dots mod 2^32.  Returns (dot [M, N] int32, row sums [M, 1] int32)."""
    m, k = x.shape
    kp, n = w.shape
    mp = -(-m // block_m) * block_m
    xs = torch.zeros((mp, 2 * 64 * -(-kp // 64)), dtype=torch.float32)
    xs[:m, :k] = x.float()
    q = torch.clamp(torch.round(xs / scale) + zp, 0, spec.max_a)
    q = torch.where(torch.arange(xs.shape[1]) < k, q, 0).to(torch.int64)
    lo, hi = q[:, 0::2], q[:, 1::2]
    w64 = w.to(torch.int64)
    lo_w, hi_w = w64 & 0xFF, (w64 >> 8) & 0xFF
    dot = torch.zeros((mp, n), dtype=torch.int64)
    sums = torch.zeros(mp, dtype=torch.int64)
    for k0 in range(0, kp, block_k):
        part = torch.zeros((mp, n), dtype=torch.int64)
        for s0 in range(k0, min(kp, k0 + block_k), 64):
            s = slice(s0, min(kp, s0 + 64))
            part += lo[:, s] @ hi_w[s] + hi[:, s] @ lo_w[s]
            sums += (lo[:, s] + hi[:, s]).sum(dim=1)
        assert int(part.min()) >= 0 and int(part.max()) < 2**31
        dot = (dot + part) & 0xFFFFFFFF
    return tpack.wrap_i32(dot[:m]), sums[:m, None].to(torch.int32)


def filtered_quantize(x, scale, zp, qmax):
    """QuantA's lattice (csrc/mma_s8.cuh) in numpy float32, step by step:
    t = x * fl(1 / scale); 1.5 * 2^23 + t, whose bits less those of
    1.5 * 2^23 are rint(t), clamped with the zero point (held to +-2^22) in
    integers; and K1's own arithmetic (the IEEE divide) for the values
    within |t| * 2^-21 of a half-integer (which takes in |t| >= 2^20) or
    not finite (all of them unless 1 / scale is a normal number).
    Returns (lattice, mask of the values that took the divide)."""
    x = np.asarray(x, np.float32)
    s = np.float32(scale)
    magic = np.float32(1.5 * 2 ** 23)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        inv = np.float32(1) / s
        t = x * inv
        y = t + magic
        d = t - (y - magic)
        # fma(|t|, 2^-21, |d|): the product is exact, the sum rounded once
        c = (np.abs(t).astype(np.float64) * 2.0 ** -21
             + np.abs(d).astype(np.float64)).astype(np.float32)
        slow = ~(c < np.float32(0.5))
        if not (np.isfinite(inv) and abs(inv) >= np.float32(2.0 ** -126)):
            slow[:] = True
        zpi = min(max(int(zp), -2 ** 22), 2 ** 22)
        n = y.view(np.int32).astype(np.int64) - 0x4B400000 + zpi
        fast_q = np.clip(n, 0, qmax)
        return np.where(slow, k1_quantize(x, s, zp, qmax), fast_q), slow


def k1_quantize(x, scale, zp, qmax):
    """K1's lattice (csrc/quant_pack.cu) in numpy float32:
    clip(rint(x / scale) + float(zp), 0, qmax) with an IEEE divide."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        q = np.rint(np.asarray(x, np.float32) / np.float32(scale)) \
            + np.float32(zp)
        return np.clip(q, 0, qmax).astype(np.int64)


@pytest.mark.parametrize("scale", [0.37, 0.25, 1 / 3 ** 0.5, 1e-3, 3.3e4,
                                   2.0 ** -130, 1e35, 2.0 ** 127])
def test_reciprocal_filter_is_exact(scale):
    """The fused quantize's filter gives K1's lattice exactly: on spread
    values (of which a tiny share takes the divide), on exact half-steps
    (n + 0.5) * scale and their neighbours within 8 ulps (all decided
    right, most by the divide), at and beyond the clamps' reach, with
    zero points near and far past +-2^22, and for scales whose reciprocal
    is not a normal number (every value takes the divide)."""
    rng = np.random.default_rng(7)
    s = np.float32(scale)
    with np.errstate(over="ignore"):   # the largest scales overflow some x
        spread = (rng.standard_normal(200_000) * 3 * np.float64(s)).astype(
            np.float32)
        halves = ((rng.integers(-300, 300, 20_000) + 0.5) * np.float64(s)
                  ).astype(np.float32)
        near = np.concatenate([halves] + [np.nextafter(
            halves, np.float32(np.inf) * sgn, dtype=np.float32) for sgn in
            (1, -1)])
        for _ in range(3):
            near = np.concatenate([near, np.nextafter(
                near[-2 * halves.size:], np.float32(np.inf),
                dtype=np.float32)])
        wide = (rng.standard_normal(20_000)
                * 2.0 ** rng.integers(-30, 40, 20_000)
                * np.float64(s)).astype(np.float32)
        specials = np.array([0.0, -0.0, 1024 * s, -1024 * s, 2.0 ** 20 * s,
                             3e38, -3e38, np.float32(2.0 ** -149), np.inf,
                             -np.inf], np.float32)
    with np.errstate(over="ignore"):
        inv = np.float32(1) / s
    normal_inv = bool(np.isfinite(inv)) and abs(inv) >= 2.0 ** -126
    for zp, qmax in ((2, 3), (0, 255), (128, 255), (-3, 7),
                     (2 ** 22 + 5, 255), (-(2 ** 22) - 5, 255),
                     (2 ** 31 - 1, 3), (-(2 ** 31), 3)):
        for x in (spread, near, wide, specials):
            got, slow = filtered_quantize(x, s, zp, qmax)
            np.testing.assert_array_equal(got, k1_quantize(x, s, zp, qmax))
            if x is spread and normal_inv:
                assert slow.mean() < 1e-3
            if x is near and normal_inv:
                assert slow[:halves.size].all()


def activations(m, k, dtype, seed, scale):
    """x [m, k] of ``dtype``: normal values of a few steps, a third at
    exact half-steps (n + 0.5) * scale (scale a power of two, so x / scale
    is exact and rounding takes the even neighbour) and a tenth beyond
    both clamps."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((m, k)) * 2.5 * scale
    half = (rng.integers(-5, 5, (m, k)) + 0.5) * scale
    far = rng.choice([-1e3, 1e3], (m, k))
    pick = rng.random((m, k))
    v = np.where(pick < 0.33, half, np.where(pick > 0.9, far, v))
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


def weights(k, n, spec, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=g) * 0.05
    zp = torch.tensor(1 << (spec.w_bits - 1), dtype=torch.int32)
    w_scale = torch.tensor(0.021)
    wp, cs = ops.prepare_weights(w, w_scale, zp, spec)
    return wp, cs, w_scale, zp


@pytest.mark.parametrize("scale", [0.25, 0.37])
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n", [(5, 203, 130), (9, 128, 70),
                                   (17, 1001, 200)])
def test_prologue_emulation_equals_k1_and_the_lanes_dot(m, k, n, x_dtype,
                                                        scale):
    """The prologue stage by stage equals K1's plain version followed by
    the packed-lane dot, dot and row sums, at odd K (a lane half past K),
    M off the block's rows, with the planner's split, one split and a
    split a stage; at half-steps and beyond both clamps."""
    x = activations(m, k, x_dtype, m + k, scale)
    wp, _, _, _ = weights(k, n, SPEC, k)
    a_scale = torch.tensor(scale)
    a_zp = torch.tensor(2, dtype=torch.int32)
    a, a_sums = tqp.quantize_pack_torch(x, a_scale, a_zp, SPEC)
    want = tpack.packed_lanes_matmul(a, wp, SPEC)
    plan = fused_plan(m, k, n, x_dtype)
    kp = wp.shape[0]
    for block_k in {plan.block_k, 64, -(-kp // 64) * 64}:
        dot, sums = quant_mma_emulation(x, wp, a_scale, a_zp, SPEC, block_k,
                                        plan.block_m)
        assert torch.equal(dot, want), block_k
        assert torch.equal(sums, a_sums), block_k


def test_plain_k1_casts_before_dividing():
    """The plain K1 divides in f32 whatever x's dtype: bf16 x gives the
    lattice of x.float().  Dividing in bf16 (a bf16 tensor over a 0-dim
    f32 scale stays bf16) would round the quotient first and move some
    values across a rounding boundary."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 256), generator=g) * 2).to(torch.bfloat16)
    scale = torch.tensor(0.37)
    zp = torch.tensor(8, dtype=torch.int32)
    sp = PackSpec.parse("W4A4/int32xP2s16")
    got = tqp.quantize_pack_torch(x, scale, zp, sp)
    want = tqp.quantize_pack_torch(x.float(), scale, zp, sp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (x / scale).dtype == torch.bfloat16
    in_bf16 = torch.clamp(torch.round(x / scale) + zp, 0, 15)
    in_f32 = torch.clamp(torch.round(x.float() / scale) + zp, 0, 15)
    assert not torch.equal(in_bf16.float(), in_f32)


# ---------------------------------------------------------------------------
# (c) The plain route against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=str)
@pytest.mark.parametrize("rows", [1, 6])
def test_plain_route_matches_repro_on_each_dtype(base_layouts, x_dtype,
                                                 rows):
    """ops.quantized_linear on f32 / bf16 / f16 x (the port's plain route)
    against repro's quantized_linear ('xla') on x.astype(float32): the
    integer core (lattice lanes, row sums, the packed dot) exact, the
    output within 1e-5 relative and absolute (same lattice, same
    correction; only f32 rounding order may differ), with a bias."""
    import jax.numpy as jnp

    from repro.core import packing as jpack
    from repro.kernels import ops as jops

    k, n = 41, 24
    x = activations(rows, k, x_dtype, rows, 0.25)
    wp, cs, w_scale, w_zp = weights(k, n, SPEC, 3)
    a_scale = torch.tensor(0.25)
    a_zp = torch.tensor(2, dtype=torch.int32)
    bias = torch.randn((n,), generator=torch.Generator().manual_seed(4))
    js = jpack.PackSpec.parse(str(SPEC))
    xf = x.float().numpy()
    j = {name: jnp.asarray(t.numpy()) for name, t in (
        ("wp", wp), ("cs", cs), ("a_scale", a_scale), ("a_zp", a_zp),
        ("w_scale", w_scale), ("w_zp", w_zp), ("bias", bias))}
    want_l, want_rs = jops.quantize_pack(jnp.asarray(xf), j["a_scale"],
                                         j["a_zp"], js, backend="xla")
    got_l, got_rs = ops.quantize_pack(x, a_scale, a_zp, SPEC)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(want_rs))
    np.testing.assert_array_equal(
        ops.packed_matmul(got_l, wp, SPEC).numpy(),
        np.asarray(jops.packed_matmul(want_l, j["wp"], js, backend="xla")))
    want = np.asarray(jops.quantized_linear(
        jnp.asarray(xf), j["wp"], j["cs"], j["a_scale"], j["a_zp"],
        j["w_scale"], j["w_zp"], js, bias=j["bias"], backend="xla"))
    got = ops.quantized_linear(x, wp, cs, a_scale, a_zp, w_scale, w_zp,
                               SPEC, bias=bias)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["W2A2/int16xP2s8", "W2A2/int32xP2s16",
                                  "W1A1/int16xP4s4", "W1A1/int8xP2s4"])
def test_routing_by_layout_on_cuda_plans(monkeypatch, text):
    """On a 'cuda' plan every layout takes the fused route: one call of
    the fused kernel with x in its own dtype (bf16, no cast), no K1 call,
    no CUDA-core K2 and no lanes route.  The CUDA wrappers are stood in by
    their plain versions; the output equals the plain route's."""
    sp = PackSpec.parse(text)
    m, k, n = 3, 40, 24
    x = activations(m, k, torch.bfloat16, 9, 0.25)
    wp, cs, w_scale, w_zp = weights(k, n, sp, 5)
    a_scale = torch.tensor(0.25)
    a_zp = torch.tensor(1 << (sp.a_bits - 1), dtype=torch.int32)
    args = (x, wp, cs, a_scale, a_zp, w_scale, w_zp, sp)
    want = ops.quantized_linear(*args, out_dtype=torch.bfloat16)
    calls = []
    quantize_pack = ops.quantize_pack

    def fused(x2, w, col_sums, a_scale, a_zp, w_scale, w_zp, spec, *, plan,
              bias, out_dtype):
        calls.append(("fused", x2.dtype))
        a, a_sums = tqp.quantize_pack_torch(x2, a_scale, a_zp, spec)
        acc = tpack.packed_lanes_matmul(a, w, spec).float()
        out = (acc - w_zp.float() * a_sums.float()
               - a_zp.float() * col_sums.float()
               + k * a_zp.float() * w_zp.float()) * (a_scale * w_scale)
        return out.to(out_dtype)

    def k1(x, s, z, spec, **kw):
        calls.append(("k1", x.dtype))
        return quantize_pack(x, s, z, spec, backend="torch")

    def core(a, w, spec, **geometry):
        calls.append(("k2", a.dtype))
        return tmm.ulppack_matmul_torch(a, w, spec)

    def lanes_mma(*args, **kwargs):
        raise AssertionError("the lanes route of the tensor-core K2 ran")

    monkeypatch.setattr(tmm, "quantized_linear_mma_cuda", fused)
    monkeypatch.setattr(ops, "quantize_pack", k1)
    monkeypatch.setattr(tmm, "ulppack_matmul_cuda", core)
    monkeypatch.setattr(tmm, "ulppack_matmul_mma_cuda", lanes_mma)
    assert tplan.packed_matmul_on_tensor_cores(sp)
    plan = tplan._plan_quantized_linear(m, k, n, sp, 2, "cpu", "lanes")
    assert plan.op == "quantized_linear" and plan.backend == "cuda"
    got = ops.quantized_linear(*args, plan=plan, out_dtype=torch.bfloat16)
    assert calls == [("fused", torch.bfloat16)]
    assert torch.equal(got, want)


def test_dense_apply_hands_the_activations_on_uncast(monkeypatch):
    """dense_apply passes the activations to ops.quantized_linear in their
    own dtype (the plain route casts inside K1, so the output is the one
    of x.float())."""
    qcfg = QuantConfig(enabled=True, w_bits=2, a_bits=2)
    p = common.dense_init(torch.Generator().manual_seed(0), 40, 24,
                          quantized=True, qcfg=qcfg)
    p = common.pack_dense_params(p, qcfg)
    x = activations(4, 40, torch.bfloat16, 2, 0.25)
    seen = []
    quantized_linear = ops.quantized_linear

    def spy(x, *args, **kwargs):
        seen.append(x.dtype)
        return quantized_linear(x, *args, **kwargs)

    monkeypatch.setattr(ops, "quantized_linear", spy)
    got = common.dense_apply(p, x, qcfg=qcfg, quant_mode="packed")
    want = common.dense_apply(p, x.float(), qcfg=qcfg, quant_mode="packed")
    assert seen == [torch.bfloat16, torch.float32]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_fused_wrapper_refuses_what_it_does_not_take():
    """CPU tensors, a plan of another layout, an x dtype the kernel does
    not read, weight lanes of another K, and the lanes route asked for
    without row sums all raise before any launch."""
    x = torch.zeros((4, 16))
    wp, cs, w_scale, w_zp = weights(16, 8, SPEC, 1)
    plan = fused_plan(4, 16, 8, torch.float32)
    args = (cs, 0.25, 2, w_scale, w_zp)
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.quantized_linear_mma_cuda(x, wp, *args, SPEC, plan=plan)
    s32 = PackSpec(2, 2, "int32", 2, 16)
    wp32, _, _, _ = weights(16, 8, s32, 1)
    with pytest.raises(ValueError, match="not the fused route's"):
        tmm.quantized_linear_mma_cuda(x, wp32, *args, s32, plan=plan)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tmm.quantized_linear_mma_cuda(x.double(), wp, *args, SPEC, plan=plan)
    with pytest.raises(ValueError, match="lanes"):
        tmm.quantized_linear_mma_cuda(torch.zeros((4, 18)), wp, *args, SPEC,
                                      plan=plan)
    with pytest.raises(ValueError, match="row sums"):
        tmm.ulppack_matmul_mma_cuda(
            torch.zeros((4, 8), dtype=torch.int16), wp, SPEC,
            plan=tplan.plan_packed_matmul(4, 8, 8, SPEC, weight_store="lanes"),
            epilogue=tmm.Affine(None, cs, 0.25, 2, w_scale, w_zp, 16))


# ---------------------------------------------------------------------------
# (e) On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


#: (rows, Kp, N) of the tensor-core K2 on the serving path (chip_smoke.py's
#: K2_MMA_CASES).
K2_MMA_CASES = ((4, 1024, 2048), (4, 1024, 5632), (4, 2816, 2048),
                (64, 1024, 5632), (64, 1024, 2048), (64, 2816, 2048))


def card_case(dev, m, k, n, x_dtype, bias_dtype, seed):
    """Weights, scalars, x (half-steps and clamped values among them) and
    a bias on the card."""
    wp, cs, w_scale, w_zp = weights(k, n, SPEC, seed)
    x = activations(m, k, x_dtype, seed + 1, 0.25)
    bias = None if bias_dtype is None else torch.randn(
        (n,), generator=torch.Generator().manual_seed(seed + 2)).to(
            bias_dtype).to(dev)
    a_scale = torch.tensor(0.25, device=dev)
    a_zp = torch.tensor(2, dtype=torch.int32, device=dev)
    return (x.to(dev), wp.to(dev), cs.to(dev), a_scale, a_zp,
            w_scale.to(dev), w_zp.to(dev)), bias


def two_launch(x, wp, cs, a_scale, a_zp, w_scale, w_zp, bias, out_dtype):
    """The route the fused kernel replaces: K1 on x.float(), then the
    tensor-core K2 on the lanes with the affine epilogue."""
    a, a_sums = tqp.quantize_pack_cuda(x.float(), a_scale, a_zp, SPEC)
    plan = tplan.plan_packed_matmul(a.shape[0], a.shape[1], wp.shape[1],
                                    SPEC,
                                        weight_store="lanes", device=x.device)
    return tmm.ulppack_matmul_mma_cuda(a, wp, SPEC, plan=plan, epilogue=(
        tmm.Affine(a_sums, cs, a_scale, a_zp, w_scale, w_zp, x.shape[1],
                   bias, out_dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [None, torch.bfloat16], ids=str)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=str)
@pytest.mark.parametrize("m,kp,n", K2_MMA_CASES, ids=str)
def test_fused_bit_equal_on_the_card(hopper, m, kp, n, x_dtype, out_dtype,
                                     bias):
    """ops.quantized_linear at stablelm's six K2 shapes is one launch of
    the fused kernel (no K1 launch), bit-equal to K1 + K2-affine and to
    the plain route."""
    args, b = card_case(hopper, m, 2 * kp, n, x_dtype, bias, m + kp + n)
    plan = tplan.plan_quantized_linear(m, 2 * kp, n, SPEC, x_dtype,
                                       weight_store="lanes",
                                       device=hopper)
    assert plan.op == "quantized_linear" and plan.backend == "cuda"
    tmm.reset_counts()
    tqp.reset_counts()
    got = ops.quantized_linear(*args, SPEC, bias=b, out_dtype=out_dtype)
    assert tmm.mma_launches == {"s32": 0, "affine": 0, "quant_affine": 1}
    assert tqp.kernel_launches == 0
    want = ops.quantized_linear(*args, SPEC, bias=b, out_dtype=out_dtype,
                                backend="torch")
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(got, two_launch(*args, b, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", X_DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n", [(9, 203, 130), (65, 1001, 200),
                                   (1, 4097, 70), (17, 40000, 8)], ids=str)
def test_fused_odd_k_ragged_m_and_splits(hopper, m, k, n, x_dtype):
    """Odd K (x rows off 16 bytes: the copy ladder), M off every block
    size, N off the tile, with the planner's splits, one split and a
    split a stage: bit-equal to the two-launch and the plain route."""
    args, _ = card_case(hopper, m, k, n, x_dtype, torch.float32, k)
    plan = tplan.plan_quantized_linear(m, k, n, SPEC, x_dtype,
                                       weight_store="lanes",
                                       device=hopper)
    kp = -(-k // 2)
    want = ops.quantized_linear(*args, SPEC, backend="torch")
    assert torch.equal(two_launch(*args, None, torch.float32), want)
    one = dataclasses.replace(plan, block_k=-(-kp // 64) * 64, splits=1)
    many = dataclasses.replace(plan, block_k=64, splits=-(-kp // 64))
    for p in (plan, one, many):
        if p.block_k > tplan.ULPPACK_MMA_MAX_BLOCK_K or p.splits > 65535:
            continue
        got = tmm.quantized_linear_mma_cuda(*args, SPEC, plan=p)
        assert torch.equal(got, want), p.describe()


@pytest.mark.cuda
def test_fused_repeats_and_graph_replay(hopper):
    """Split-K tickets go back to 0 and the row sums' workspace is
    rewritten: a second launch, three in a row, and the calls replayed
    from a CUDA graph all give the same bits."""
    args, b = card_case(hopper, 4, 2048, 2048, torch.bfloat16,
                        torch.bfloat16, 7)
    plan = tplan.plan_quantized_linear(4, 2048, 2048, SPEC, torch.bfloat16,
                                       weight_store="lanes",
                                       device=hopper)
    assert plan.splits > 1
    want = ops.quantized_linear(*args, SPEC, bias=b, backend="torch",
                                out_dtype=torch.bfloat16)

    def call():
        return tmm.quantized_linear_mma_cuda(*args, SPEC, plan=plan, bias=b,
                                             out_dtype=torch.bfloat16)

    assert all(torch.equal(call(), want) for _ in range(3))
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


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(stages=-1), dict(smem_bytes=16), dict(block_m=24),
    dict(x_bytes=4), dict(splits=1)])
def test_fused_launcher_refuses_a_plan_that_disagrees(hopper, change):
    """A plan whose ring, shared memory, rows or split count disagrees
    with the kernel's layout for x's dtype is refused by the launcher
    (CUDA error); one made for another element size by the wrapper."""
    args, _ = card_case(hopper, 8, 1200, 70, torch.bfloat16, None, 3)
    plan = tplan.plan_quantized_linear(8, 1200, 70, SPEC, torch.bfloat16,
                                       weight_store="lanes",
                                       device=hopper)
    assert torch.equal(tmm.quantized_linear_mma_cuda(*args, SPEC, plan=plan),
                       ops.quantized_linear(*args, SPEC, backend="torch"))
    f, v = next(iter(change.items()))
    bad = dataclasses.replace(plan, **{f: v if f in ("block_m", "x_bytes")
                                       else getattr(plan, f) + v})
    err = ValueError if f == "x_bytes" else RuntimeError
    with pytest.raises(err, match="fused route" if f == "x_bytes"
                       else "CUDA error"):
        tmm.quantized_linear_mma_cuda(*args, SPEC, plan=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 7), (5, 37), (64, 2048)], ids=str)
@pytest.mark.parametrize("spec", ["W2A2/int16xP2s8", "W2A2/int32xP4s8",
                                  "W4A4/int32xP2s16", "W1A1/int8xP2s4"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float16],
                         ids=str)
def test_quantize_pack_reads_its_dtype_bit_equal(hopper, x_dtype, spec, m,
                                                 k):
    """The standalone K1 on bf16 / f16 x, read in its own dtype, is
    bit-equal to its plain version (which casts to f32 first)."""
    sp = PackSpec.parse(spec)
    x = activations(m, k, x_dtype, m + k, 0.25).to(hopper)
    scale = torch.tensor(0.25, device=hopper)
    zp = torch.tensor(1 << (sp.a_bits - 1), dtype=torch.int32, device=hopper)
    tqp.reset_counts()
    got = tqp.quantize_pack_cuda(x, scale, zp, sp)
    assert tqp.kernel_launches == 1
    want = tqp.quantize_pack_torch(x, scale, zp, sp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
