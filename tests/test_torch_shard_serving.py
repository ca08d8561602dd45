"""Tensor-parallel serving in the port (``repro_torch/serve/shard.py``,
``parallel/sharding.py``, ``launch/mesh.py``, the sharded forward of
``models/common.dense_apply`` and ``models/attention.attention_apply``)
on the CPU.

A mesh of 2 or 4 ``cpu`` devices runs every sharded code path: each
column-split Dense one plain K2 call a shard at its local width, each
kv-head-split cache one window write and one K3 / K4 read a shard.  The
sharded engine's tokens equal the one-shard engine's and the reference's
single-device engine's (its steps op by op, on the same weights bridged)
at W2/W4 x kv 16/4/2, paged, with kv heads the shards do not divide, and
for reduced jamba (MoE, mamba and attention in one stack); each shard
holds only its columns and kv heads; the specs agree leaf by leaf with
the reference's ``ShardPlan`` on a 4-wide ``model`` axis (a
``jax.sharding.AbstractMesh`` on one host device), the MoE router's
kernel apart.  The card's cases (two shards on one card graphed,
two distinct cards eager) are in ``tests/test_torch_cuda_graphs.py``,
which imports no JAX."""

import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro.serve.shard import ShardPlan as JShardPlan  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import autotune, ulppack_attention  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402
from repro_torch.serve import prepare  # noqa: E402
from repro_torch.serve.engine import (EngineConfig, Request,  # noqa: E402
                                      ServingEngine)
from repro_torch.serve.shard import ShardPlan  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty (and the reference's, whose
    packing the spec test reads)."""
    old, jold = autotune.active_cache(), jautotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)
    jautotune.set_active_cache(jold)


def cpu_mesh(n):
    return ServingMesh([["cpu"] * n])


def quant(w_bits, kv_bits, mod=QuantConfig):
    return mod(enabled=True, w_bits=w_bits, a_bits=w_bits,
               lane_dtype="int16" if w_bits < 4 else "int32",
               kv_bits=kv_bits)


@functools.lru_cache(maxsize=None)
def model(name="stablelm-1.6b", w_bits=2, kv_bits=4):
    cfg = configs.get_config(name, reduced=True).replace(
        quant=quant(w_bits, kv_bits))
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu")


ECFG = dict(max_batch=3, max_len=48, prefill_chunk=4, page_size=16)


def drive(module, eng, vocab, new=5):
    """Tokens of five staggered requests (chunked prefill with decode
    riders) through ``module``'s engine ``eng``."""
    rng = np.random.default_rng(5)
    reqs = [module.Request(i, rng.integers(0, vocab, n).astype(np.int32),
                           max_new_tokens=new)
            for i, n in enumerate((7, 3, 11, 5, 18))]
    for r in reqs[:3]:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.output) for r in reqs]


def serve(cfg, params, mesh=None, paged=False, new=5):
    """The port's tokens for :func:`drive`'s requests, and the engine."""
    eng = ServingEngine(cfg, params, device="cpu", mesh=mesh,
                        config=EngineConfig(**ECFG, paged=paged))
    return drive(engine_lib, eng, cfg.vocab_size, new), eng


@functools.lru_cache(maxsize=None)
def one_shard(name, w_bits, kv_bits, paged):
    return serve(*model(name, w_bits, kv_bits), paged=paged)[0]


@functools.lru_cache(maxsize=None)
def reference(name, w_bits, kv_bits, paged):
    """The reference's single-device engine on the same weights and
    requests, its steps op by op (DESIGN.md section 15: sharded tokens
    equal these)."""
    jcfg = jconfigs.get_config(name, reduced=True).replace(
        quant=quant(w_bits, kv_bits, JQ))
    jp = jax.tree.map(jnp.asarray,
                      bridge.to_repro(model(name, w_bits, kv_bits)[1]))
    with jax.disable_jit():
        eng = jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(
            **ECFG, paged=paged))
        return drive(jengine, eng, jcfg.vocab_size)


# ---------------------------------------------------------------------------
# Token identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("w_bits,kv_bits,paged", [
    (2, 16, False), (2, 4, False), (2, 2, False), (4, 16, False),
    (4, 4, False), (4, 2, False), (2, 4, True), (4, 2, True)])
def test_sharded_tokens_equal_one_shard(w_bits, kv_bits, paged, shards):
    cfg, params = model("stablelm-1.6b", w_bits, kv_bits)
    got, eng = serve(cfg, params, cpu_mesh(shards), paged=paged)
    assert got == one_shard("stablelm-1.6b", w_bits, kv_bits, paged)
    assert got == reference("stablelm-1.6b", w_bits, kv_bits, paged)
    assert all(len(o) == 5 for o in got)
    kv = lm.first_attn_cache(eng.caches)
    assert isinstance(kv["k"], sharding.Sharded)
    assert len(kv["k"].parts) == shards
    assert eng.capacity_report()["shard_plan"]["model_shards"] == shards


def test_gqa_kv_heads_that_do_not_divide_stay_whole():
    """qwen2-vl's 2 kv heads over 4 shards: the caches stay whole and the
    attention reads run once; the projections still split by columns and
    the tokens are the one-shard engine's.  Over 2 shards each holds one
    kv head and its 2 query heads."""
    cfg, params = model("qwen2-vl-2b", 2, 4)
    want = one_shard("qwen2-vl-2b", 2, 4, False)
    assert want == reference("qwen2-vl-2b", 2, 4, False)
    got, eng = serve(cfg, params, cpu_mesh(4))
    assert got == want
    kv = lm.first_attn_cache(eng.caches)
    assert all(isinstance(t, torch.Tensor) for t in kv.values())
    assert isinstance(eng.params["layers"][0]["attn"]["q"]["w_packed"],
                      sharding.Sharded)
    got, eng = serve(cfg, params, cpu_mesh(2))
    assert got == want
    kv = lm.first_attn_cache(eng.caches)
    assert [p.shape[2] for p in kv["k"].parts] == [1, 1]


def test_reduced_jamba_two_shards():
    """MoE, mamba and attention layers in one stack: the packed
    projections split; the MoE router's kernel, the 3-D experts and the
    recurrent states stay whole."""
    name = "jamba-1.5-large-398b"
    cfg, params = model(name, 2, 4)
    got, eng = serve(cfg, params, cpu_mesh(2))
    assert got == one_shard(name, 2, 4, False)
    assert got == reference(name, 2, 4, False)
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    assert {"attn", "mamba"} <= kinds
    for layer, cache in zip(eng.params["layers"], eng.caches):
        if "moe" in layer:
            assert isinstance(layer["moe"]["router"]["kernel"], torch.Tensor)
            assert isinstance(layer["moe"]["up"]["kernel"], torch.Tensor)
        if "mamba" in cache:
            assert all(isinstance(t, torch.Tensor)
                       for t in cache["mamba"].values())


def test_mesh_of_one_is_the_single_device_engine():
    cfg, params = model()
    got, eng = serve(cfg, params, cpu_mesh(1))
    assert got == one_shard("stablelm-1.6b", 2, 4, False)
    leaves = [v for _, v in _flat(eng.params)] + \
        [v for _, v in _flat(eng.caches)]
    assert not any(isinstance(v, sharding.Sharded) for v in leaves)
    cap = eng.capacity_report()
    assert cap["shard_plan"]["model_shards"] == 1
    assert cap["shard_plan"]["param_bytes"]["split"] == [0]


def test_speculative_under_a_mesh_raises():
    cfg, params = model()
    with pytest.raises(NotImplementedError, match="item 14b"):
        ServingEngine(cfg, params, device="cpu", mesh=cpu_mesh(2),
                      config=EngineConfig(speculative_k=2, max_len=48))


def test_engine_refuses_a_mesh_of_several_rows():
    cfg, params = model()
    with pytest.raises(ValueError, match="Router"):
        ServingEngine(cfg, params, device="cpu",
                      mesh=ServingMesh([["cpu"], ["cpu"]]))


# ---------------------------------------------------------------------------
# What each shard holds
# ---------------------------------------------------------------------------

def _flat(tree, path="", spec_leaves=False):
    """(path, leaf) pairs; ``spec_leaves``: a tuple is a spec (a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}", spec_leaves)
    elif isinstance(tree, list) or (isinstance(tree, tuple)
                                    and not spec_leaves):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}", spec_leaves)
    else:
        yield path, tree


@pytest.mark.parametrize("shards", [2, 4])
def test_each_shard_holds_its_columns_and_kv_heads(shards):
    cfg, params = model()
    _, one = serve(cfg, params)
    _, eng = serve(cfg, params, cpu_mesh(shards))
    whole = dict(_flat(one.params))
    for path, leaf in _flat(eng.params):
        if not isinstance(leaf, sharding.Sharded):
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf, whole[path]), path
            continue
        n = whole[path].shape[-1] // shards
        assert leaf.axis == whole[path].dim() - 1
        for i, part in enumerate(leaf.parts):
            assert part.is_contiguous() and part.shape[-1] == n
            assert torch.equal(part, whole[path][..., i * n:(i + 1) * n])
        assert torch.equal(leaf.whole(), whole[path])
    kvh = cfg.num_kv_heads // shards
    for layer in eng.caches:
        for name, leaf in layer["attn"].items():
            assert leaf.axis == 2
            assert [p.shape[2] for p in leaf.parts] == [kvh] * shards
    rep = eng.capacity_report()
    pb = rep["shard_plan"]["param_bytes"]
    split_one = sum(t.numel() * t.element_size()
                    for p, t in _flat(one.params)
                    if isinstance(t, torch.Tensor)
                    and isinstance(dict(_flat(eng.params))[p],
                                   sharding.Sharded))
    assert pb["split"] == [split_one // shards] * shards
    assert pb["whole"] + split_one == one.capacity_report()["param_bytes"]
    assert pb["per_shard"] == [pb["whole"] + split_one // shards] * shards
    assert rep["param_bytes"] == one.capacity_report()["param_bytes"]


def test_plans_describe_the_shard_product():
    """build_layer_plans(shard_plan=) plans each packed leaf at N / tp: the
    engine's plans are the planner's (memoized) answers for the shard's
    [rows, Kp] x [Kp, N / tp] product, the ones a shard's launch
    dispatches through."""
    from repro_torch.core.packing import PackSpec
    cfg, params = model()
    _, eng = serve(cfg, params, cpu_mesh(2))
    spec, x_dtype = PackSpec.from_config(cfg.quant), torch.float32
    hd = cfg.resolved_head_dim
    widths = {"q": (cfg.d_model, cfg.num_heads * hd),
              "k": (cfg.d_model, cfg.num_kv_heads * hd),
              "o": (cfg.num_heads * hd, cfg.d_model),
              "down": (cfg.d_ff, cfg.d_model)}
    for name, sub in (("q", "attn"), ("k", "attn"), ("o", "attn"),
                      ("down", "mlp")):
        k, n = widths[name]
        for rows, key in ((3, f"layers[1]/{sub}/{name}"),
                          (12, f"layers[1]/{sub}/{name}@prefill")):
            want = plan_lib.plan_quantized_linear(
                rows, k, n // 2, spec, x_dtype, weight_store="lanes",
                backend="auto", device=torch.device("cpu"))
            assert eng.plans[key] is want, key
    tpk = prepare.prepare_serving_params(params, cfg, device="cpu")
    plans = prepare.build_layer_plans(
        tpk, cfg, batch_rows=3, shard_plan=ShardPlan(cpu_mesh(4)))
    assert plans["layers[0]/mlp/down"] is plan_lib.plan_quantized_linear(
        3, cfg.d_ff, cfg.d_model // 4, spec, x_dtype, weight_store="lanes",
        backend="auto", device=torch.device("cpu"))


def test_shard_launches_at_local_shapes(monkeypatch):
    """One prefill chunk of a 2-shard engine: for every packed Dense call
    [Kp, N] of the one-shard engine, two calls [Kp, N / 2]; every
    attention layer one cache write and one fused read a shard over its
    KVH / 2 kv heads and H / 2 query heads."""
    from repro_torch.kernels import ops
    cfg, params = model()
    real_ql, real_read = ops.quantized_linear, \
        ulppack_attention.fused_decode_attention

    def launches(mesh):
        _, eng = serve(cfg, params, mesh)
        seen, reads = [], []

        def ql(x, w, *a, **kw):
            seen.append(tuple(w.shape))
            return real_ql(x, w, *a, **kw)

        def read(q, cache, *a, **kw):
            reads.append((q.shape[2], cache["k"].shape[2]))
            return real_read(q, cache, *a, **kw)

        monkeypatch.setattr(ops, "quantized_linear", ql)
        monkeypatch.setattr(ulppack_attention, "fused_decode_attention",
                            read)
        eng.submit(Request(0, np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=2))
        eng.step()
        monkeypatch.undo()
        return seen, reads

    whole, whole_reads = launches(None)
    split, split_reads = launches(cpu_mesh(2))
    assert split == [(kp, n // 2) for kp, n in whole for _ in range(2)]
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    assert whole_reads == [(h, kvh)] * cfg.num_layers
    assert split_reads == [(h // 2, kvh // 2)] * (2 * cfg.num_layers)


# ---------------------------------------------------------------------------
# Specs against the reference's ShardPlan
# ---------------------------------------------------------------------------

def _model_axis(spec):
    """The index of the axis a spec splits over 'model' (None: whole)."""
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("name,w_bits", [("stablelm-1.6b", 2),
                                         ("qwen2-vl-2b", 4),
                                         ("jamba-1.5-large-398b", 2)])
def test_param_pspec_agrees_with_the_reference(name, w_bits):
    """Every leaf of the packed serving tree gets the reference's spec on a
    4-wide model axis, but for the MoE router's kernel, which the port
    keeps whole (routing reads every expert's logit, so no shard computes
    on a part) and the reference splits by columns; the same weights
    bridged give the same packed leaves, so the two trees walk alike."""
    jcfg = jconfigs.get_config(name, reduced=True).replace(
        quant=quant(w_bits, 4, JQ))
    cfg = configs.get_config(name, reduced=True).replace(
        quant=quant(w_bits, 4))
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = prepare.prepare_serving_params(
        bridge.from_repro(jax.device_get(jp), device="cpu"), cfg,
        device="cpu")
    ref = JShardPlan(AbstractMesh((1, 4), ("data", "model")))
    port = ShardPlan(cpu_mesh(4))
    assert port.model_shards == ref.model_shards == 4
    port_leaves = dict(_flat(tpk))
    n_split = 0
    for path, leaf in _flat(jpk):
        if path not in port_leaves or not hasattr(leaf, "shape"):
            continue
        got = port.param_pspec(path, port_leaves[path]) \
            if isinstance(port_leaves[path], torch.Tensor) else ()
        want = tuple(ref.param_pspec(path, leaf))
        if path.endswith("/router/kernel"):
            assert want == (None, "model") and got == (None, None), path
            continue
        assert got == want, path
        n_split += sharding.MODEL in got
    assert n_split > 0
    placed = port.place_params(tpk)
    for path, leaf in _flat(placed):
        spec = port.param_pspec(path, port_leaves[path]) \
            if isinstance(port_leaves[path], torch.Tensor) else ()
        assert isinstance(leaf, sharding.Sharded) == (sharding.MODEL in spec)


@pytest.mark.parametrize("kv_bits,paged", [(16, False), (8, False),
                                           (4, True), (2, False)])
def test_cache_shardings_agree_with_the_reference(kv_bits, paged):
    """Attention K/V and scale planes split axis 2 (the kv heads) exactly
    where the reference's do -- the page axis of a pool stays whole.  The
    recurrent states stay whole in the port (the reference splits their
    channels: ROADMAP item 14b)."""
    from repro.parallel import sharding as jsharding
    name = "jamba-1.5-large-398b" if not paged else "stablelm-1.6b"
    jcfg = jconfigs.get_config(name, reduced=True).replace(
        quant=quant(2, kv_bits, JQ))
    cfg = configs.get_config(name, reduced=True).replace(
        quant=quant(2, kv_bits))
    kw = dict(page_size=16, num_pages=6) if paged else {}
    tc = lm.init_caches(cfg, 3, 32, device="cpu", **kw)
    jc = jlm.init_caches(jcfg, 3, 32, **kw)
    # jamba's 2 kv heads over 2 shards, stablelm's 4 over 4
    tp = cfg.num_kv_heads
    amesh = AbstractMesh((1, tp), ("data", "model"))
    want = jsharding.cache_shardings(jc, jcfg, amesh, 3,
                                     kv_head_shard=True, paged=paged)
    got = sharding.cache_shardings(tc, cpu_mesh(tp))
    got_flat = dict(_flat(got, spec_leaves=True))
    assert len(got_flat) == len(list(_flat(want)))
    for path, sh in _flat(want):
        ref_axis = _model_axis(sh.spec)
        port = got_flat[path]
        if re.search(r"attn/(k|v|k_scale|v_scale)$", path):
            assert _model_axis(port) == ref_axis == 2, path
        else:
            assert _model_axis(port) is None, path


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def test_host_mesh_clamps_with_a_warning():
    with pytest.warns(UserWarning, match="clamping to"):
        mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == ((torch.device("cpu"),),)
    mesh = mesh_lib.make_serving_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert tuple(mesh.axis_names) == ("data", "model")


def test_mesh_axes_are_validated():
    with pytest.raises(ValueError, match="data"):
        mesh_lib.make_serving_mesh(model=1, data=0, device="cpu")
    with pytest.raises(ValueError, match="model"):
        mesh_lib.make_serving_mesh(model=0, data=1, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh_lib.make_host_mesh(data=1, model=0, device="cpu")
    with pytest.raises(ValueError, match="rows differ"):
        ServingMesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="at least one"):
        ServingMesh([])


def test_host_mesh_counts_the_cards(monkeypatch):
    """On the card the host mesh counts torch.cuda.device_count()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = mesh_lib.make_serving_mesh(model=2, data=2)
    assert [[str(d) for d in r] for r in mesh.devices] == \
        [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
    with pytest.warns(UserWarning, match="clamping"):
        assert mesh_lib.make_serving_mesh(model=8).shape == \
            {"data": 1, "model": 4}


def test_shard_plan_guards_and_describes():
    plan = ShardPlan(cpu_mesh(4))
    assert plan.shards_of(12) == 4 and plan.shards_of(10) == 1
    assert plan.local_out(12) == 3 and plan.local_out(10) == 10
    assert plan.param_pspec("/x/q/w_packed", torch.zeros(3, 10)) \
        == (None, None)
    assert plan.param_pspec("/x/q/col_sums", torch.zeros(8)) == ("model",)
    assert plan.param_pspec("/x/q/a_scale", torch.zeros(())) == ()
    assert plan.param_pspec("/embed/table", torch.zeros(8, 8)) \
        == (None, None)
    assert plan.describe() == {"mesh": {"data": 1, "model": 4},
                               "tp_axis": "model", "model_shards": 4,
                               "devices": ["cpu"] * 4}
    assert plan.param_pspec("/layers/0/moe/router/kernel",
                            torch.zeros(8, 4)) == (None, None)
    assert plan.param_pspec("/layers/0/mlp/up/kernel",
                            torch.zeros(8, 4)) == (None, "model")


def test_paged_state_round_trips_through_whole_leaves():
    """export_paged_state gives whole tensors; import_paged_state copies
    them back into each kv-head shard's part, in place."""
    cfg, params = model()
    _, eng = serve(cfg, params, cpu_mesh(2), paged=True)
    caches, meta = eng.export_paged_state()
    kv = caches[0]["attn"]["k"]
    assert isinstance(kv, torch.Tensor) and kv.shape[2] == cfg.num_kv_heads
    _, other = serve(cfg, params, cpu_mesh(2), paged=True, new=3)
    ptrs = [p.data_ptr() for p in other.caches[0]["attn"]["k"].parts]
    other.import_paged_state(caches, meta)
    got = other.caches[0]["attn"]["k"]
    assert torch.equal(got.whole(), kv)
    assert [p.data_ptr() for p in got.parts] == ptrs
