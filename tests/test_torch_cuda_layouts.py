"""K2 and K5 on the int8 tensor cores for every layout of the family but
int16xP2s8 (``csrc/ulppack_matmul_mma_lanes.cu``, the raw-slot halo of
``csrc/ulppack_conv2d_mma.cu``), on the card, against their plain versions
and the CUDA-core K2 / K5 tile on the same operands.  Marked
``cuda``: every test skips (inside the ``hopper`` fixture, never at
import) unless a CUDA device of capability (9, 0) or newer is present.
Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_layouts.py

The CPU side (the staging's emulation, the planner, the engine and the
CNN against ``repro``) is ``tests/test_torch_layouts_mma.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import ops, quant_pack  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.kernels import ulppack_conv2d, ulppack_matmul  # noqa: E402

pytestmark = pytest.mark.cuda


def _layout_cases() -> list[str]:
    """For every layout but int16xP2s8 and every w_bits of the dense store
    (1, 2, 4) it holds, the widest a_bits it holds with it."""
    out = []
    for lane, n, s in packing.LAYOUT_FAMILY:
        if (lane, n, s) == ("int16", 2, 8):
            continue
        for w in plan_lib.DENSE_MMA_W_BITS:
            a = max((a for a in range(1, 5) if PackSpec(
                w, a, lane, n, s).feasible), default=None)
            if a is not None:
                out.append(f"W{w}A{a}/{lane}xP{n}s{s}")
    return out


LAYOUT_CASES = _layout_cases()
#: stablelm-1.6b's K2 shapes as lattice (K, N): q/k/v/o and gate/up at K
#: 2048, down at K 5632 (chip_smoke.py's K2_MMA_CASES).
STABLELM_KN = ((2048, 2048), (2048, 5632), (5632, 2048))


@pytest.fixture(autouse=True)
def empty_port_cache():
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


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _lattice(g, dev, hi, shape):
    return torch.randint(0, hi + 1, shape, generator=g, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k,n", STABLELM_KN, ids=lambda v: str(v))
@pytest.mark.parametrize("text", LAYOUT_CASES)
def test_k2_every_layout_bit_equal(hopper, text, k, n, m):
    """K2 with lanes in, over the layout's lanes and over the dense store,
    and the fused ``ops.quantized_linear`` (bf16 x, K1 folded in) over
    both stores: each one launch of the tensor-core K2, bit-equal to the
    plain version and to the CUDA-core K2 on the same lanes; no CUDA-core
    K2 and no standalone K1 on the routes."""
    sp = PackSpec.parse(text)
    g = _gen(hopper, k + n + m)
    kp = -(-k // sp.n_pack)
    qa = _lattice(g, hopper, sp.max_a, (m, k))
    qw = _lattice(g, hopper, sp.max_w, (k, n))
    a = packing.pack_activations(qa, sp)
    w = packing.pack_weights(qw, sp)
    words = ops.dense_store_weights(qw, sp.w_bits)
    want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)
    core = ulppack_matmul.ulppack_matmul_cuda(
        a, w, sp, **plan_lib.packed_matmul_core_geometry(m, kp, n, sp,
                                                         hopper))
    assert torch.equal(core, want)
    ulppack_matmul.reset_counts()
    quant_pack.reset_counts()
    for store, wt in (("lanes", w), ("dense", words)):
        plan = plan_lib.plan_packed_matmul(m, kp, n, sp, weight_store=store,
                                           k_full=k, device=hopper)
        assert plan.backend == "cuda" and plan.block_n == 128
        got = ops.packed_matmul(a, wt, sp, plan=plan)
        assert torch.equal(got, want), (store, plan.describe())
    x = (torch.randn((m, k), generator=g, device=hopper) * 1.5).bfloat16()
    args = (qw.sum(dim=0, dtype=torch.int32),
            torch.tensor(3 ** -0.5, device=hopper),
            torch.tensor((sp.max_a + 1) // 2, dtype=torch.int32,
                         device=hopper),
            torch.tensor(0.02, device=hopper),
            torch.tensor((sp.max_w + 1) // 2, dtype=torch.int32,
                         device=hopper))
    for store, wt in (("lanes", w), ("dense", words)):
        got = ops.quantized_linear(x, wt, *args, sp, weight_store=store,
                                   out_dtype=torch.bfloat16)
        plain = ops.quantized_linear(x, wt, *args, sp, weight_store=store,
                                     backend="torch",
                                     out_dtype=torch.bfloat16)
        assert torch.equal(got, plain), store
    torch.cuda.synchronize()
    assert ulppack_matmul.mma_launches == {"s32": 1, "affine": 0,
                                           "quant_affine": 1}
    assert ulppack_matmul.dense_mma_launches == ulppack_matmul.mma_launches
    assert ulppack_matmul.kernel_launches["ulppack_matmul"] == 0
    assert quant_pack.kernel_launches == 0


@pytest.mark.parametrize("text", ["W4A4/int32xP2s16", "W1A1/int8xP2s4",
                                  "W2A1/int16xP4s4", "W2A4/int32xP4s8"])
def test_k2_every_layout_splits_repeats_and_graph_replay(hopper, text):
    """One split, one stage a split and the planner's splits bit-equal; the
    fused call three times in a row and replayed from a CUDA graph gives
    the same bits (the split-K tickets go back to 0)."""
    sp = PackSpec.parse(text)
    g = _gen(hopper, 7)
    m, k, n = 9, 4104, 200
    kp = -(-k // sp.n_pack)
    qa = _lattice(g, hopper, sp.max_a, (m, k))
    qw = _lattice(g, hopper, sp.max_w, (k, n))
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)
    plan = plan_lib.plan_packed_matmul(m, kp, n, sp, weight_store="lanes",
                                       device=hopper)
    steps = -(-plan_lib.mma_k(kp, sp) // 64)
    for p in (plan,
              dataclasses.replace(plan, block_k=64 * steps, splits=1),
              dataclasses.replace(plan, block_k=64, splits=steps)):
        got = ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=p)
        assert torch.equal(got, want), p.describe()
    x = torch.randn((m, k), generator=g, device=hopper).bfloat16()
    args = (qw.sum(dim=0, dtype=torch.int32), torch.tensor(0.4,
                                                           device=hopper),
            torch.tensor(1, dtype=torch.int32, device=hopper),
            torch.tensor(0.02, device=hopper),
            torch.tensor(1, dtype=torch.int32, device=hopper))
    fplan = plan_lib.plan_quantized_linear(m, k, n, sp, torch.bfloat16,
                                           weight_store="lanes",
                                           device=hopper)
    fwant = ops.quantized_linear(x, w, *args, sp, backend="torch",
                                 out_dtype=torch.bfloat16)

    def call():
        return ops.quantized_linear(x, w, *args, sp, plan=fplan,
                                    out_dtype=torch.bfloat16)

    assert all(torch.equal(call(), fwant) for _ in range(3))
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
        assert all(torch.equal(o, fwant) for o in outs)


def test_k2_long_split_at_the_lattice_extremes(hopper):
    """W4A4 int32xP2s16 at 15 x 15 every product: the longest split, 16384
    K steps (32,768 values x 225), keeps the s32 sums in range; the total
    over 40,000 lanes equals the plain version."""
    sp = PackSpec.parse("W4A4/int32xP2s16")
    m, kp, n = 5, 40000, 70
    qa = torch.full((m, 2 * kp), 15, dtype=torch.int32, device=hopper)
    qw = torch.full((2 * kp, n), 15, dtype=torch.int32, device=hopper)
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    want = ulppack_matmul.ulppack_matmul_torch(a, w, sp)
    assert int(want[0, 0]) == 225 * 2 * kp
    plan = plan_lib.plan_packed_matmul(m, kp, n, sp, weight_store="lanes",
                                       device=hopper)
    longest = dataclasses.replace(
        plan, block_k=plan_lib.ULPPACK_MMA_MAX_BLOCK_K,
        splits=-(-kp // plan_lib.ULPPACK_MMA_MAX_BLOCK_K))
    for p in (plan, longest):
        got = ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=p)
        assert torch.equal(got, want), p.describe()


def test_k2_launcher_refuses_another_layout(hopper):
    """A plan or lanes of a layout the library was not built for are
    refused by its launcher, which raises."""
    sp = PackSpec.parse("W2A2/int32xP2s16")
    g = _gen(hopper, 3)
    qa = _lattice(g, hopper, 3, (4, 256))
    qw = _lattice(g, hopper, 3, (256, 64))
    a, w = packing.pack_activations(qa, sp), packing.pack_weights(qw, sp)
    plan = plan_lib.plan_packed_matmul(4, 128, 64, sp, weight_store="lanes",
                                       device=hopper)
    other = PackSpec.parse("W2A2/int32xP2s8")
    fn = ulppack_matmul.build.bind(
        "ulppack_matmul_mma_int32xP2s16", "ulppack_matmul_mma_lanes_launch",
        12, 21)
    out = torch.empty((4, 64), dtype=torch.int32, device=hopper)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), 0, 0, 0, 0, 0, 0, 0,
           0, 0, 4, 128, 64, 0, 0, 0, 0, 0, 0, 0, plan.block_m, 128, 64,
           plan.block_k, plan.splits, plan.stages, 256, plan.smem_bytes,
           other.lane_bytes, other.n_pack, other.shift, 0,
           torch.cuda.current_stream().cuda_stream)
    bad = dataclasses.replace(plan, stages=plan.stages + 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ulppack_matmul.ulppack_matmul_mma_cuda(a, w, sp, plan=bad)


# (N, H, W, Cin, Fh, Fw, Co, padding, store): small grids with ragged
# edges and channel counts that fill no lane, then the Fig. 4 shape.
CONV_GEOMS = [
    (1, 9, 10, 3, 3, 3, 8, "SAME", "lanes"),
    (2, 7, 19, 8, 3, 3, 32, "VALID", "dense"),
    (1, 11, 37, 17, 5, 4, 64, "SAME", "dense"),
    (2, 6, 5, 32, 7, 7, 8, "SAME", "lanes"),
    (1, 13, 12, 40, 3, 3, 9, "VALID", "lanes"),
]


def _conv_case(dev, text, geom, seed):
    n, h, w, cin, fh, fw, co, padding, store = geom
    sp = PackSpec.parse(text)
    g = _gen(dev, seed)
    qx = _lattice(g, dev, sp.max_a, (n, h, w, cin))
    qw = _lattice(g, dev, sp.max_w, (fh, fw, cin, co))
    xp = packing.pack_activations(qx, sp)
    wp = (ops.dense_store_conv_weights(qw, sp.w_bits) if store == "dense"
          else packing.pack_weights(qw, sp, axis=2))
    k_full = cin if store == "dense" else None
    plan = plan_lib.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp,
                                       padding=padding, weight_store=store,
                                       k_full=k_full, device=dev)
    kw = dict(padding=padding, weight_store=store, k_full=k_full)
    return sp, xp, wp, plan, kw


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=lambda g: "-".join(
    map(str, g)))
@pytest.mark.parametrize("text", LAYOUT_CASES)
def test_k5_every_layout_bit_equal(hopper, text, geom):
    """The tensor-core K5 at every layout, lanes and dense: bit-equal to
    the plain K5 and to the CUDA-core tile on the same operands; one
    launch a call on the tensor cores."""
    sp, xp, wp, plan, kw = _conv_case(hopper, text, geom, len(text))
    assert plan.route == "tensor_cores"
    want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)
    ulppack_conv2d.reset_counts()
    got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding=kw["padding"])
    assert torch.equal(got, want)
    assert ulppack_conv2d.kernel_launches["ulppack_conv2d_mma"] == 1
    core = plan_lib.packed_conv2d_core_geometry(
        tuple(xp.shape), tuple(wp.shape), padding=kw["padding"],
        device=hopper)
    assert torch.equal(ulppack_conv2d.ulppack_conv2d_cuda(xp, wp, sp, **core,
                                                          **kw), want)


@pytest.mark.parametrize("text", ["W1A1/int8xP2s4", "W1A1/int16xP4s4",
                                  "W1A1/int32xP4s8", "W1A1/int32xP2s16"])
def test_k5_fig4_bit_equal(hopper, text):
    """Fig. 4's conv (x [1, 256, 256, 32], 7x7, 32 out, VALID) at W1A1 on
    the tensor cores, bit-equal to the plain K5 and the CUDA-core tile."""
    geom = (1, 256, 256, 32, 7, 7, 32, "VALID", "lanes")
    sp, xp, wp, plan, kw = _conv_case(hopper, text, geom, 4)
    assert plan.route == "tensor_cores"
    want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)
    assert torch.equal(ulppack_conv2d.ulppack_conv2d_mma_cuda(
        xp, wp, sp, plan=plan, **kw), want)
    core = plan_lib.packed_conv2d_core_geometry(
        tuple(xp.shape), tuple(wp.shape), padding="VALID", device=hopper)
    assert torch.equal(ulppack_conv2d.ulppack_conv2d_cuda(xp, wp, sp, **core,
                                                          **kw), want)


@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_k5_w4a4_cnn_layer_fused_epilogue(hopper, store):
    """sparq-cnn's 32 -> 64 layer at W4A4 int32xP2s16 (one 256 x 256
    image): cnn.conv_apply is one tensor-core K5 launch with the affine
    dequant fused in, bit-equal to the plain K5 + the eager patch sums and
    epilogue."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import cnn

    qcfg = QuantConfig(enabled=True, w_bits=4, a_bits=4, lane_dtype="int32")
    g = _gen(hopper, 5)
    p = cnn.conv_prepare(cnn.conv_init(g, 7, 7, 32, 64, qcfg,
                                       device=hopper), qcfg,
                         weight_store=store)
    x = torch.randn((1, 256, 256, 32), generator=g, device=hopper) * 2
    ulppack_conv2d.reset_counts()
    got = cnn.conv_apply(p, x, qcfg, quant_mode="packed")
    assert ulppack_conv2d.mma_launches == {"s32": 0, "affine": 1}
    assert sum(ulppack_conv2d.plain_calls.values()) == 0
    want = cnn.conv_epilogue(cnn.conv_integer_core(p, x, qcfg,
                                                   backend="torch"))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_k5_past_the_shared_memory_takes_the_cuda_cores(hopper):
    """A conv whose weight block does not fit the tensor cores' shared
    memory whole plans the tensor cores in channel chunks (route
    'tensor_cores', one launch of the tensor-core K5), for an int16xP2s8
    and an int32xP2s16 layout: bit-equal to the plain K5 and to the
    CUDA-core tile, which is on no route."""
    for text in ("W2A2/int16xP2s8", "W2A2/int32xP2s16"):
        sp = PackSpec.parse(text)
        cin = 1024
        geom = (1, 8, 8, cin, 7, 7, 8, "SAME", "lanes")
        sp, xp, wp, plan, kw = _conv_case(hopper, text, geom, 2)
        assert plan.route == "tensor_cores" and plan.chunks > 1
        ulppack_conv2d.reset_counts()
        got = ops.packed_conv2d(xp, wp, sp, plan=plan, padding="SAME")
        assert ulppack_conv2d.kernel_launches["ulppack_conv2d_mma"] == 1
        assert ulppack_conv2d.kernel_launches["ulppack_conv2d"] == 0
        want = ulppack_conv2d.ulppack_conv2d_torch(xp, wp, sp, **kw)
        assert torch.equal(got, want)
        core = plan_lib.packed_conv2d_core_geometry(
            tuple(xp.shape), tuple(wp.shape), padding="SAME", device=hopper)
        assert torch.equal(
            ulppack_conv2d.ulppack_conv2d_cuda(xp, wp, sp, **core, **kw), want)