"""The bit-dense weight store (``dense_store=True``: int32 words of w_bits
lattice values, ``w_dense`` leaves) against the JAX reference and against
the lanes store.

- ``pack_dense_params(dense_store=True)`` leaves byte-equal to
  ``repro``'s ``w_dense``, ``col_sums`` and ``k_full`` at W1-W4, odd K.
- ``ops.quantized_linear`` on the dense store bit-equal to the lanes store
  and to ``repro``'s dense route ('xla'), at W1-W4 and odd K.
- A plain emulation of the tensor-core K2's dense W staging (``DenseW`` in
  ``csrc/mma_s8.cuh``: the swizzled word ring, the thread items, the
  masked tail, the plane stores) equal to the byte planes the lanes route
  splits its lanes into, at stablelm's K2 shapes and at K off a word.
- The planner's dense geometry and its constants against the sources,
  and its refusals.
- A reduced-stablelm engine with ``dense_store=True``: greedy tokens equal
  to the lanes engine's and to the reference's dense engine run op by op.
- Card cases (marked ``cuda``; they skip without a Hopper card): the dense
  route bit-equal to its plain version and to the lanes route, split-K
  and graph replay included.  Run on the card with
  ``PYTHONPATH=src python -m pytest -q -m cuda
  tests/test_torch_dense_store.py``.
"""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_matmul as tmm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

torch.set_num_threads(2)

CSRC = Path(tplan.__file__).resolve().parent.parent / "csrc"
# (w_bits, a_bits): W1-W4 on int16 lanes of two bytes (W4 at A2: W4A4 has
# no int16 layout)
BITS = ((1, 1), (2, 2), (3, 3), (4, 2))


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def _spec(w, a):
    return PackSpec.from_config(TQ(w_bits=w, a_bits=a))


def _dense_params(k, n, seed):
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return {"kernel": kernel,
            "w_step": np.float32(np.abs(kernel).max() / 3),
            "a_step": np.float32(0.37)}


# ---------------------------------------------------------------------------
# Leaves and the plain route against the reference
# ---------------------------------------------------------------------------

@pytest.fixture
def base_layouts():
    """Pin the reference's per-layer lane layout to the config's base spec
    (an empty tuning cache), the only layout the port serves."""
    from repro.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _reference_leaves(p, w, a, dense):
    import jax.numpy as jnp
    from repro.core.quant import QuantConfig as JQ
    from repro.models import common as jcommon
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return jcommon.pack_dense_params(jp, JQ(enabled=True, w_bits=w,
                                            a_bits=a), dense_store=dense)


@pytest.mark.parametrize("k", [64, 203])
@pytest.mark.parametrize("w,a", BITS, ids=str)
def test_dense_leaves_byte_equal_to_reference(base_layouts, w, a, k):
    p = _dense_params(k, 40, w * k)
    want = _reference_leaves(p, w, a, True)
    got = tcommon.pack_dense_params(
        {kk: torch.as_tensor(v) for kk, v in p.items()},
        TQ(enabled=True, w_bits=w, a_bits=a), dense_store=True)
    assert "w_packed" not in got and got["k_full"] == want["k_full"] == k
    assert got["w_dense"].dtype == torch.int32
    assert got["w_dense"].shape == (tplan.dense_words(k, w), 40)
    for key in ("w_dense", "col_sums", "w_scale", "w_zp", "a_scale", "a_zp"):
        assert got[key].numpy().tobytes() == np.asarray(want[key]).tobytes()
    lanes = tcommon.pack_dense_params(
        {kk: torch.as_tensor(v) for kk, v in p.items()},
        TQ(enabled=True, w_bits=w, a_bits=a))
    assert torch.equal(lanes["col_sums"], got["col_sums"])
    assert torch.equal(tmm.dense_to_lanes(got["w_dense"], _spec(w, a), k),
                       lanes["w_packed"])


@pytest.mark.parametrize("m,k,n", [(3, 203, 40), (1, 64, 130)], ids=str)
@pytest.mark.parametrize("w,a", BITS, ids=str)
def test_quantized_linear_dense_equals_lanes_and_reference(base_layouts, w,
                                                           a, m, k, n):
    import jax.numpy as jnp
    from repro.core.packing import PackSpec as JSpec
    from repro.kernels import ops as jops
    p = _dense_params(k, n, m + k + n)
    qc = TQ(enabled=True, w_bits=w, a_bits=a)
    tp = {kk: torch.as_tensor(v) for kk, v in p.items()}
    dense = tcommon.pack_dense_params(tp, qc, dense_store=True)
    lanes = tcommon.pack_dense_params(tp, qc)
    x = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    spec = _spec(w, a)

    def run(leaves, key, store):
        return ops.quantized_linear(
            torch.from_numpy(x), leaves[key], leaves["col_sums"],
            leaves["a_scale"], leaves["a_zp"], leaves["w_scale"],
            leaves["w_zp"], spec, weight_store=store, backend="torch")

    got = run(dense, "w_dense", "dense")
    assert torch.equal(got, run(lanes, "w_packed", "lanes"))
    jl = _reference_leaves(p, w, a, True)
    want = jops.quantized_linear(
        jnp.asarray(x), jl["w_dense"], jl["col_sums"], jl["a_scale"],
        jl["a_zp"], jl["w_scale"], jl["w_zp"], JSpec.parse(str(spec)),
        backend="xla", weight_store="dense")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the s32 core alone: the dense packed matmul on a's lanes
    a_lanes, _ = ops.quantize_pack(torch.from_numpy(x), dense["a_scale"],
                                   dense["a_zp"], spec, backend="torch")
    assert torch.equal(
        ops.packed_matmul(a_lanes, dense["w_dense"], spec,
                          weight_store="dense", k_full=k, backend="torch"),
        ops.packed_matmul(a_lanes, lanes["w_packed"], spec,
                          weight_store="lanes", backend="torch"))


# ---------------------------------------------------------------------------
# The kernel's dense W staging, emulated
# ---------------------------------------------------------------------------

BK, BN, THREADS, PLANE_ROW = 64, 128, 256, 80


def plane_off(r, kk):
    """csrc/mma_s8.cuh plane_off: byte of (plane row r, lane kk)."""
    return r * PLANE_ROW + ((((kk >> 4) ^ (r >> 3)) & 3) << 4) + (kk & 15)


def dense_stage_emulation(words, k_full, w_bits, k0, n0):
    """The hi and lo W planes [2, BN * PLANE_ROW] bytes that ``DenseW``
    (csrc/mma_s8.cuh) builds for stage k0 (lanes) of the block at columns
    n0: ``stage`` copies word rows [k0 / kL, ..) of the block's 128
    columns into a ring slot, each 16-byte chunk at chunk_pos<16 + RW>
    (columns past N and rows past the split zeroed), and ``expand``'s
    thread items read one word each, mask the values past k_full, split
    its even values into the hi plane and its odd ones into the lo plane
    and store them at plane_off(n, r * kL)."""
    per = 32 // w_bits
    kl = per // 2
    rows = BK // kl
    rw = 16 // kl
    cw = 32 // rw
    kw, n = words.shape
    r0 = k0 // kl
    k_lanes = -(-k_full // 2)
    rows_valid = -(-min(k_lanes, k0 + BK) // kl) - r0
    # the ring slot: rows x 128 words, chunk c of row r at chunk_pos(r, c)
    slot = np.zeros(rows * BN, np.uint32)
    r_idx, c_idx = np.meshgrid(np.arange(rows), np.arange(BN // 4),
                               indexing="ij")
    pos = c_idx ^ ((r_idx % rw) * (8 // rw))
    for j in range(4):
        col = n0 + 4 * c_idx + j
        ok = (r_idx < rows_valid) & (col < n) & (r0 + r_idx < kw)
        src = words[np.minimum(r0 + r_idx, kw - 1), np.minimum(col, n - 1)]
        slot[r_idx * BN + 4 * pos + j] = np.where(ok, src, 0)
    # expand: thread items (item, thread) -> (word row r, column nn)
    e = np.arange(rows * BN)
    lane, g = e & 31, e >> 5
    col_groups = BN // cw
    r = (g // col_groups) * rw + lane % rw
    nn = (g % col_groups) * cw + lane // rw
    w = slot[r * BN + 4 * ((nn >> 2) ^ ((r % rw) * (8 // rw))) + (nn & 3)]
    nv = k_full - (2 * k0 + r * per)
    mask = np.where(nv >= per, 0xFFFFFFFF,
                    np.where(nv > 0, (1 << (w_bits * np.clip(nv, 0, 31)))
                             - 1, 0)).astype(np.uint64)
    w = (w.astype(np.uint64) & mask).astype(np.uint32)
    planes = np.zeros((2, BN * PLANE_ROW), np.uint8)
    fmask = (1 << w_bits) - 1
    for i in range(kl):
        off = plane_off(nn, r * kl + i)
        planes[0, off] = (w >> (2 * w_bits * i)) & fmask
        planes[1, off] = (w >> (2 * w_bits * i + w_bits)) & fmask
    return planes


def lanes_planes(lanes, k0, n0):
    """The planes the lanes route holds for stage k0 of columns n0 after
    its transposing pass: plane 0 the hi byte of each field-reversed lane
    (value 2k), plane 1 the lo byte (value 2k + 1), at plane_off(n, k)."""
    kp, n = lanes.shape
    planes = np.zeros((2, BN * PLANE_ROW), np.uint8)
    kk, nn = np.meshgrid(np.arange(BK), np.arange(BN), indexing="ij")
    ok = (k0 + kk < kp) & (n0 + nn < n)
    v = lanes[np.minimum(k0 + kk, kp - 1), np.minimum(n0 + nn, n - 1)]
    v = np.where(ok, v.astype(np.int32) & 0xFFFF, 0)
    off = plane_off(nn, kk)
    planes[0, off] = v >> 8
    planes[1, off] = v & 0xFF
    return planes


@pytest.mark.parametrize("w_bits", tplan.DENSE_MMA_W_BITS)
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 5632), (5632, 2048),
                                 (203, 130), (1001, 70), (8, 260)],
                         ids=str)
def test_dense_staging_emulation_equals_lanes_planes(w_bits, k, n):
    """stablelm's K2 shapes (q/k/v/o, gate/up, down) and K off a word, N
    off the tile: every stage's planes from the words equal the lanes
    route's (the first, a middle and the last stage; every column tile
    for the small shapes, the first and last for stablelm's)."""
    spec = _spec(w_bits, min(w_bits, 2))
    rng = np.random.default_rng(k + n + w_bits)
    q = torch.from_numpy(rng.integers(0, 1 << w_bits, (k, n))
                         .astype(np.int32))
    words = ops.dense_store_weights(q, w_bits).numpy().view(np.uint32)
    lanes = tpack.pack_weights(q, spec, axis=0).numpy()
    kp = -(-k // 2)
    stages = sorted({0, (kp // BK // 2) * BK, ((kp - 1) // BK) * BK})
    tiles = range(0, n, BN) if n <= 260 else (0, ((n - 1) // BN) * BN)
    for k0 in stages:
        for n0 in tiles:
            np.testing.assert_array_equal(
                dense_stage_emulation(words, k, w_bits, k0, n0),
                lanes_planes(lanes, k0, n0), err_msg=f"{k0} {n0}")


# ---------------------------------------------------------------------------
# The planner and the sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_bits", tplan.DENSE_MMA_W_BITS)
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 2048, 5632),
                                   (4, 5632, 2048), (64, 2048, 2048),
                                   (64, 2048, 5632), (64, 5632, 2048),
                                   (20, 2048, 5632)], ids=str)
def test_dense_plan_geometry(w_bits, m, k, n):
    """The dense plans keep the lanes' rows and splits (the same split
    model), record the store and K, split K on words, and hold the ring
    of smem_bytes_w for the words' tile: deeper, or as deep in less
    shared memory."""
    spec = _spec(w_bits, min(w_bits, 2))
    for x_dtype in (torch.float32, torch.bfloat16):
        dense = tplan._plan_quantized_linear(m, k, n, spec, x_dtype.itemsize,
                                             "cpu", "dense")
        lanes = tplan._plan_quantized_linear(m, k, n, spec, x_dtype.itemsize,
                                             "cpu", "lanes")
        assert (dense.weight_store, dense.k_full) == ("dense", k)
        assert (dense.block_m, dense.splits, dense.block_k) == (
            lanes.block_m, lanes.splits, lanes.block_k)
        assert (2 * dense.block_k) % (32 // w_bits) == 0   # whole words
        ab = 2 * x_dtype.itemsize
        tile = tplan.dense_w_tile_bytes(w_bits)
        assert tile == 2 * BK // (32 // w_bits) * BN * 4
        stage = tile + dense.block_m * (BK * ab + 16)
        planes = 2 * BN * PLANE_ROW + 2 * dense.block_m * PLANE_ROW
        assert dense.stages == min(8, (232448 - 2 * planes) // stage)
        assert dense.smem_bytes == dense.stages * stage + 2 * planes
        assert dense.stages > lanes.stages \
            or (dense.stages == lanes.stages
                and dense.smem_bytes < lanes.smem_bytes)
    p = tplan.plan_packed_matmul(m, -(-k // 2), n, spec,
                                 weight_store="dense", k_full=k)
    assert (p.op, p.backend, p.weight_store, p.k_full) == (
        "packed_matmul", "torch", "dense", k)


def test_dense_constants_match_the_sources():
    """DenseW's layout in csrc/mma_s8.cuh, the w_bits it is built for
    (the static_assert, the build's variants, the launcher's check) and
    the planner's copies agree."""
    tile = (CSRC / "mma_s8.cuh").read_text()
    src = (CSRC / "ulppack_matmul_mma_dense.cu").read_text()
    for text in ("static constexpr int kPer = 32 / BITS;",
                 "static constexpr int kL = kPer / 2;",
                 "static constexpr int kRows = kBK / kL;",
                 "static constexpr int kTile = kRows * kBN * 4;",
                 "static constexpr int RW = 16 / kL;",
                 "if constexpr (SW > 16) return c ^ ((r % (SW - 16)) * "
                 "(8 / (SW - 16)));",
                 "static_assert(BITS == 1 || BITS == 2 || BITS == 4,"):
        assert text in tile, text
    assert "if (w_bits != DENSE_W_BITS)" in src
    assert "launch_mma<DenseW<DENSE_W_BITS>>" in src
    assert {v[1][0] for v in build.VARIANTS.values()} == {
        f"-DDENSE_W_BITS={b}" for b in tplan.DENSE_MMA_W_BITS}
    assert all(n in build.SOURCES for n in build.VARIANTS)
    assert re.search(r"return c \^ \(\(r % \(SW - 16\)\)", tile)


def test_dense_refusals(monkeypatch):
    spec3 = _spec(3, 3)
    with pytest.raises(NotImplementedError, match="Queue 2, K2"):
        tplan._plan_quantized_linear(4, 2048, 2048, spec3, 2, "cpu", "dense")
    with pytest.raises(ValueError, match="weight_store"):
        tplan.plan_quantized_linear(4, 64, 64, _spec(2, 2),
                                    weight_store="bits")
    with pytest.raises(ValueError, match="k_full"):
        tplan.plan_packed_matmul(4, 32, 64, _spec(2, 2),
                                 weight_store="dense", k_full=70)
    with pytest.raises(TypeError, match="weight_store"):
        tplan.plan_packed_matmul(4, 32, 64, _spec(2, 2))
    # the plain route on CPU tensors takes w_bits 3; the dense words must
    # hold K at w_bits
    words = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 words"):
        tmm.dense_to_lanes(words, _spec(2, 2), 70)
    # the CUDA wrappers refuse CPU tensors
    spec = _spec(2, 2)
    plan = tplan._plan_quantized_linear(4, 64, 8, spec, 4, "cpu", "dense")
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.quantized_linear_mma_cuda(
            torch.zeros((4, 64)), torch.zeros((4, 8), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), 1.0, 2, 1.0, 2, spec,
            plan=plan)
    lanes_plan = tplan._plan_quantized_linear(4, 64, 8, spec, 4, "cpu",
                                              "lanes")
    with pytest.raises(ValueError, match="lanes"):
        tmm.quantized_linear_mma_cuda(
            torch.zeros((4, 64)), torch.zeros((4, 8), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), 1.0, 2, 1.0, 2, spec,
            plan=lanes_plan)


def test_dense_routes_on_cuda_plans(monkeypatch):
    """On 'cuda' plans ops.quantized_linear hands the words and the dense
    plan to the fused tensor-core wrapper, and ops.packed_matmul on an
    int32-lane layout hands the words themselves to the tensor-core K2
    (no expansion to lanes, no CUDA-core kernel; the wrappers stood in by
    the plain versions)."""
    seen = []

    def fused(x2, w, cs, a_scale, a_zp, w_scale, w_zp, spec, *, plan, bias,
              out_dtype):
        seen.append(("fused", plan.weight_store, w.dtype))
        a, a_sums = ops.quantize_pack(x2, a_scale, a_zp, spec,
                                      backend="torch")
        lanes = tmm.dense_to_lanes(w, spec, plan.k_full)
        acc = tmm.ulppack_matmul_torch(a, lanes, spec)
        return acc.float()

    def core(a, w, spec, **geometry):
        raise AssertionError("the CUDA-core K2 ran")

    def lanes_mma(a, w, spec, *, plan, epilogue=None):
        seen.append(("mma", plan.weight_store, w.dtype))
        assert plan.spec == spec and epilogue is None
        return tmm.ulppack_matmul_torch(
            a, tmm.dense_to_lanes(w, spec, plan.k_full), spec)

    monkeypatch.setattr(tmm, "quantized_linear_mma_cuda", fused)
    monkeypatch.setattr(tmm, "ulppack_matmul_cuda", core)
    monkeypatch.setattr(tmm, "ulppack_matmul_mma_cuda", lanes_mma)
    monkeypatch.setattr(tplan, "resolve_backend",
                        lambda backend="auto", device="cpu":
                        "torch" if backend == "torch" else "cuda")
    tplan._plan_packed_matmul.cache_clear()
    tplan._plan_quantized_linear.cache_clear()
    try:
        spec = _spec(2, 2)
        raw = _dense_params(64, 8, 1)
        p = tcommon.pack_dense_params(
            {k: torch.as_tensor(v) for k, v in raw.items()},
            TQ(enabled=True, w_bits=2, a_bits=2), dense_store=True)
        x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
        tcommon.dense_apply(p, x, qcfg=TQ(enabled=True, w_bits=2, a_bits=2),
                            quant_mode="packed")
        assert seen == [("fused", "dense", torch.int32)]
        s32 = PackSpec.parse("W2A2/int32xP2s16")
        q = torch.randint(0, 4, (70, 8), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
        a = tpack.pack_activations(
            torch.randint(0, 4, (3, 70), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2)), s32)
        got = ops.packed_matmul(a, ops.dense_store_weights(q, 2), s32,
                                weight_store="dense", k_full=70)
        assert seen[-1] == ("mma", "dense", torch.int32)
        assert torch.equal(got, tmm.ulppack_matmul_torch(
            a, tpack.pack_weights(q, s32, axis=0), s32))
    finally:
        tplan._plan_packed_matmul.cache_clear()
        tplan._plan_quantized_linear.cache_clear()


# ---------------------------------------------------------------------------
# The engine
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
    return [r.output for r in reqs], eng


def test_engine_dense_store_tokens_equal_lanes_and_reference(base_layouts):
    """Reduced stablelm-1.6b at W2A2, kv 4: the dense-store engine's greedy
    tokens equal the lanes engine's and the reference's dense engine run
    op by op; its packed weights take a quarter of the lanes' bytes."""
    import jax
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro.models import lm as jlm
    from repro.serve import engine as jengine
    from repro_torch import bridge
    from repro_torch.serve import engine as tengine
    from repro_torch.serve import prepare as tprepare
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4), **kw)
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4), **kw)
    jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    dense, eng = _serve(tengine, tcfg, tp, dense_store=True)
    lanes, leng = _serve(tengine, tcfg, tp)
    with jax.disable_jit():
        want, _ = _serve(jengine, jcfg, jp, dense_store=True)
    assert dense == lanes == want
    assert all(len(o) == NEW for o in dense)
    assert {p.weight_store for p in eng.plans.values()} == {"dense"}
    words = tprepare.serving_param_bytes(
        [node["w_dense"] for node in _packed_nodes(eng.params)])
    lane_bytes = tprepare.serving_param_bytes(
        [node["w_packed"] for node in _packed_nodes(leng.params)])
    assert 4 * words <= lane_bytes + 4 * 4 * 16 * 7 * tcfg.num_layers
    assert eng.capacity_report()["param_bytes"] \
        < leng.capacity_report()["param_bytes"]
    assert eng.capacity_report()["dense_store"] is True


def _packed_nodes(tree):
    if isinstance(tree, dict):
        if "col_sums" in tree:
            yield tree
            return
        for v in tree.values():
            yield from _packed_nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _packed_nodes(v)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _card_case(dev, m, k, n, w, a, x_dtype, seed):
    spec = _spec(w, a)
    qc = TQ(enabled=True, w_bits=w, a_bits=a)
    p = {kk: torch.as_tensor(v).to(dev)
         for kk, v in _dense_params(k, n, seed).items()}
    dense = tcommon.pack_dense_params(p, qc, dense_store=True)
    lanes = tcommon.pack_dense_params(p, qc)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.randn((m, k), generator=g) * 0.5).to(x_dtype).to(dev)
    return spec, x, dense, lanes


def _linear(x, leaves, key, spec, store, backend, plan=None, bias=None,
            out_dtype=torch.float32):
    return ops.quantized_linear(
        x, leaves[key], leaves["col_sums"], leaves["a_scale"],
        leaves["a_zp"], leaves["w_scale"], leaves["w_zp"], spec,
        weight_store=store, backend=backend, plan=plan, bias=bias,
        out_dtype=out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 2048, 5632),
                                   (4, 5632, 2048), (64, 2048, 5632),
                                   (20, 2048, 2048), (1, 203, 130),
                                   (17, 1001, 70), (9, 40000, 8)], ids=str)
@pytest.mark.parametrize("w,a", [(1, 1), (2, 2), (4, 2)], ids=str)
def test_dense_fused_bit_equal_on_the_card(hopper, w, a, m, k, n, x_dtype):
    """ops.quantized_linear over the dense store: one launch of the fused
    tensor-core K2 with the words expanded in its staging, bit-equal to
    the plain route and to the lanes route's launch, with the planner's
    split, one split and a split a stage."""
    spec, x, dense, lanes = _card_case(hopper, m, k, n, w, a, x_dtype, k + n)
    tmm.reset_counts()
    got = _linear(x, dense, "w_dense", spec, "dense", "auto")
    assert tmm.dense_mma_launches == {"s32": 0, "affine": 0,
                                      "quant_affine": 1}
    assert tmm.mma_launches["quant_affine"] == 0
    want = _linear(x, dense, "w_dense", spec, "dense", "torch")
    assert torch.equal(got, want)
    assert torch.equal(got, _linear(x, lanes, "w_packed", spec, "lanes",
                                    "auto"))
    plan = tplan.plan_quantized_linear(m, k, n, spec, x_dtype,
                                       weight_store="dense", device=hopper)
    kp = -(-k // 2)
    for p in (dataclasses.replace(plan, block_k=-(-kp // 64) * 64, splits=1),
              dataclasses.replace(plan, block_k=64, splits=-(-kp // 64))):
        if p.block_k > tplan.ULPPACK_MMA_MAX_BLOCK_K or p.splits > 65535:
            continue
        assert torch.equal(_linear(x, dense, "w_dense", spec, "dense",
                                   "cuda", plan=p), want), p.describe()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (64, 5632, 2048),
                                   (5, 1001, 130)], ids=str)
@pytest.mark.parametrize("w,a", [(1, 1), (2, 2), (4, 2)], ids=str)
def test_dense_s32_and_affine_bit_equal_on_the_card(hopper, w, a, m, k, n):
    """The lanes-in routes over the dense store (ops.packed_matmul's s32
    dot, and the affine epilogue) bit-equal to the lanes store's."""
    spec, x, dense, lanes = _card_case(hopper, m, k, n, w, a, torch.float32,
                                       m + k)
    a_lanes, a_sums = ops.quantize_pack(x, dense["a_scale"], dense["a_zp"],
                                        spec)
    tmm.reset_counts()
    got = ops.packed_matmul(a_lanes, dense["w_dense"], spec,
                            weight_store="dense", k_full=k)
    assert tmm.dense_mma_launches["s32"] == 1
    assert torch.equal(got, ops.packed_matmul(a_lanes, lanes["w_packed"],
                                              spec, weight_store="lanes"))
    assert torch.equal(got, ops.packed_matmul(
        a_lanes, dense["w_dense"], spec, weight_store="dense", k_full=k,
        backend="torch"))
    plan = tplan.plan_packed_matmul(m, a_lanes.shape[1], n, spec,
                                    weight_store="dense", k_full=k,
                                    device=hopper)
    ep = tmm.Affine(a_sums, dense["col_sums"], dense["a_scale"],
                    dense["a_zp"], dense["w_scale"], dense["w_zp"], k,
                    None, torch.bfloat16)
    lp = tplan.plan_packed_matmul(m, a_lanes.shape[1], n, spec,
                                  weight_store="lanes", device=hopper)
    assert torch.equal(
        tmm.ulppack_matmul_mma_cuda(a_lanes, dense["w_dense"], spec,
                                    plan=plan, epilogue=ep),
        tmm.ulppack_matmul_mma_cuda(a_lanes, lanes["w_packed"], spec,
                                    plan=lp, epilogue=ep))


@pytest.mark.cuda
def test_dense_repeats_graph_replay_and_refused_plans(hopper):
    """Three launches in a row and a CUDA-graph replay give the same bits;
    a dense plan on lanes, a lanes plan on words and a ring that is not
    the words' are refused."""
    spec, x, dense, lanes = _card_case(hopper, 4, 2048, 2048, 2, 2,
                                       torch.bfloat16, 11)
    plan = tplan.plan_quantized_linear(4, 2048, 2048, spec, torch.bfloat16,
                                       weight_store="dense", device=hopper)
    assert plan.splits > 1
    want = _linear(x, dense, "w_dense", spec, "dense", "torch",
                   out_dtype=torch.bfloat16)

    def call():
        return _linear(x, dense, "w_dense", spec, "dense", "cuda",
                       plan=plan, out_dtype=torch.bfloat16)

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
    lanes_plan = tplan.plan_quantized_linear(
        4, 2048, 2048, spec, torch.bfloat16, weight_store="lanes",
        device=hopper)
    with pytest.raises(ValueError):
        _linear(x, dense, "w_dense", spec, "dense", "cuda", plan=lanes_plan)
    with pytest.raises(ValueError):
        _linear(x, lanes, "w_packed", spec, "lanes", "cuda", plan=plan)
    for bad in (dict(stages=plan.stages + 1),
                dict(smem_bytes=plan.smem_bytes + 16)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _linear(x, dense, "w_dense", spec, "dense", "cuda",
                    plan=dataclasses.replace(plan, **bad))
