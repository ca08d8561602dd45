"""mixtral-8x22b at full width, as ``chip_smoke.py``'s ``moe 8x22b`` lines
serve it on the card, checked on the CPU: the fused K2 plans its packed
linears -- the attention projections, (4 | 64 rows) x (K 6,144 -> N 6,144)
and (K 6,144 -> N 1,024) -- with no refusal and the tile's invariants;
the served tree's bytes at the script's depth cut, counted on the
``meta`` device (the experts' lattices derived there too); and the card's
layer-at-a-time builder (``chip_smoke.build_packed_params``) equal leaf
for leaf to ``prepare_serving_params(lm.init_params(...))`` on the MoE
stacks (reduced mixtral-8x22b and jamba), lattices included.
"""

import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = PackSpec(2, 2)          # int16xP2s8, the shipped W2A2 layout
#: (rows, lattice K, N) of mixtral-8x22b's packed linears at the decode
#: rows (max_batch 4) and a 64-row chunk: q / o, then k / v
WIDE = [(m, 6144, n) for m in (4, 64) for n in (6144, 1024)]


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: the planner's heuristics."""
    old = tautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``__main__`` guard keeps the
    import free of side effects)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shapes_are_the_configs():
    """The planned shapes are the full config's attention projections, and
    the script's K2 rows are those shapes."""
    cfg = tconfigs.get_config("mixtral-8x22b")
    hd = cfg.resolved_head_dim
    assert (cfg.d_model, cfg.num_heads * hd, cfg.num_kv_heads * hd) == (
        6144, 6144, 1024)
    cs = _chip_smoke()
    assert [(k, n) for _, k, n in cs.MOE_WIDE_K2_SHAPES] == [
        (6144, 6144), (6144, 1024)]
    assert sorted({(m, k, n) for _, k, n in cs.MOE_WIDE_K2_SHAPES
                   for m in cs.MOE_WIDE_K2_ROWS}) == sorted(WIDE)


@pytest.mark.parametrize("m,k,n", WIDE, ids=str)
def test_fused_plan_at_the_wide_shapes(m, k, n):
    """The fused route (K1 folded into the tensor-core K2) plans each
    shape at bf16 activations with no refusal: the tile's rows, its K
    splits covering Kp = 3,072 lanes (each at most the kernel's largest
    block), a ring of at least 3 stages inside the block's shared memory;
    off the card the planner hands back the packed matmul's plan."""
    p = tplan._plan_quantized_linear(m, k, n, SPEC, 2, "cpu", "lanes")
    kp = k // 2
    assert (p.op, p.backend, p.k_full, p.x_bytes, p.weight_store) == (
        "quantized_linear", "cuda", k, 2, "lanes")
    assert (p.block_n, p.step_k, p.threads) == (128, 64, 256)
    assert p.block_m in (8, 16, 32, 64) and p.block_m <= max(8, m)
    assert p.block_k <= tplan.ULPPACK_MMA_MAX_BLOCK_K
    assert (p.splits - 1) * p.block_k < kp <= p.splits * p.block_k
    assert p.stages >= 3
    assert p.smem_bytes + 4 * (p.block_m + 1) <= 232448
    cpu = tplan.plan_quantized_linear(m, k, n, SPEC, torch.bfloat16,
                                      weight_store="lanes")
    assert cpu is tplan.plan_packed_matmul(m, kp, n, SPEC,
                                           weight_store="lanes")


def test_served_bytes_at_the_depth_cut():
    """The tree the script serves, built on the ``meta`` device at the
    script's depth: each layer's bf16 expert lattices (4.83 GB) and lanes
    (0.088 GB), the embedding and untied head (0.81 GB): 69.7 GB at
    MOE_WIDE_LAYERS, the cut's figures."""
    cs = _chip_smoke()
    cfg = tconfigs.get_config("mixtral-8x22b").replace(
        num_layers=cs.MOE_WIDE_LAYERS)
    packed = tprepare.prepare_serving_params(
        tlm.init_params(cfg, device="meta"), cfg, device="meta")
    moe = packed["layers"][0]["moe"]
    for name in ("up", "gate", "down"):
        assert set(moe[name]) == {"kernel", "a_step"}
        assert moe[name]["kernel"].dtype == torch.bfloat16
    experts = 3 * 8 * 6144 * 16384 * 2
    assert cs.expert_bytes(packed) == experts * cfg.num_layers
    layer = tprepare.serving_param_bytes(packed["layers"][0])
    assert 0.08e9 < layer - experts < 0.09e9
    edge = tprepare.serving_param_bytes(
        {k: v for k, v in packed.items() if k != "layers"})
    assert 0.80e9 < edge < 0.82e9
    total = tprepare.serving_param_bytes(packed)
    assert total == edge + layer * cfg.num_layers
    assert 69.5e9 < total < 69.9e9


@pytest.mark.parametrize("name", ["mixtral-8x22b", "jamba-1.5-large-398b"])
def test_layer_at_a_time_build_derives_the_lattices(name):
    """The card's layer-at-a-time builder draws in ``init_params``' order
    and prepares each block as the whole-tree call does: the same paths,
    dtypes and bytes, leaf for leaf, the experts' lattices included (no
    ``w_step`` left), so one tree serves both engines."""
    build = _chip_smoke().build_packed_params
    cfg = tconfigs.get_config(name, reduced=True)
    got = build(cfg, torch.Generator().manual_seed(0), "cpu")
    want = tprepare.prepare_serving_params(
        tlm.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu"), cfg, device="cpu")
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    experts = [p for p, _ in got if "/moe/" in p and p.endswith("/kernel")
               and "/router/" not in p]
    assert experts and not [p for p, _ in got if p.endswith("/w_step")
                            and "/moe/" in p]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert torch.equal(g.view(torch.uint8) if g.dim() else g,
                               w.view(torch.uint8) if w.dim() else w), path
        else:
            assert g == w, path


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree
