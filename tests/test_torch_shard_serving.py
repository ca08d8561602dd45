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
for reduced jamba (MoE, mamba and attention in one stack); a speculative
engine under a mesh (lanes and dense drafts, paged and not) gives the
one-shard speculative engine's tokens and acceptance counts, and the
reference's speculative engine's (op by op); each shard
holds only its columns and kv heads; the specs agree leaf by leaf with
the reference's ``ShardPlan`` on a 4-wide ``model`` axis (a
``jax.sharding.AbstractMesh`` on one host device), the MoE router's
kernel apart, and the cache specs on every leaf, recurrent states
included.  The channel-split recurrent states are in
``tests/test_torch_shard_recurrent.py``.  The card's cases (two shards
on one card graphed, speculative and recurrent too; two distinct cards
eager) are in ``tests/test_torch_cuda_graphs.py``, which imports no
JAX."""

import functools

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
    projections split; the MoE router's kernel and the 3-D experts stay
    whole; the mamba states split their channels (``conv`` on axis 2,
    ``ssm`` on axis 1)."""
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
            conv, ssm = cache["mamba"]["conv"], cache["mamba"]["ssm"]
            assert isinstance(conv, sharding.Sharded) and conv.axis == 2
            assert isinstance(ssm, sharding.Sharded) and ssm.axis == 1


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
    """Speculation under a mesh is refused where it is refused without
    one: on a stack with recurrent layers (the verify window's rollback
    does not hold for their states)."""
    cfg, params = model("jamba-1.5-large-398b")
    with pytest.raises(ValueError, match="recurrent"):
        ServingEngine(cfg, params, device="cpu", mesh=cpu_mesh(2),
                      config=EngineConfig(speculative_k=2, max_len=48))


#: The speculative engines' draft settings: 'lanes' a W2 draft, 'dense' a
#: W1 draft over the dense store (the target's words dense too).
DRAFTS = {"lanes": dict(draft_w_bits=2),
          "dense": dict(draft_w_bits=1, dense_store=True)}


def spec_counts(eng):
    m = eng.metrics
    return m.drafted_tokens, m.accepted_tokens, m.spec_cycles


def spec_serve(draft, paged, mesh=None):
    """Tokens, acceptance counts and engine of a speculative engine (k =
    2, :data:`DRAFTS`) on :func:`drive`'s requests."""
    cfg, params = model()
    eng = ServingEngine(cfg, params, device="cpu", mesh=mesh,
                        config=EngineConfig(**ECFG, paged=paged,
                                            speculative_k=2,
                                            **DRAFTS[draft]))
    got = drive(engine_lib, eng, cfg.vocab_size)
    return got, spec_counts(eng), eng


@functools.lru_cache(maxsize=None)
def spec_one_shard(draft, paged):
    return spec_serve(draft, paged)[:2]


def reference_engine(ecfg):
    """The reference's single-device engine on :func:`model`'s weights
    bridged, with ``ecfg``'s settings; call it under
    ``jax.disable_jit()`` (its steps op by op)."""
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=quant(2, 4, JQ))
    jp = jax.tree.map(jnp.asarray, bridge.to_repro(model()[1]))
    return jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(
        **ecfg))


@functools.lru_cache(maxsize=None)
def spec_reference(draft, paged):
    """The reference's speculative engine's tokens and acceptance counts
    on :func:`spec_serve`'s weights, settings and requests, its steps op
    by op."""
    with jax.disable_jit():
        eng = reference_engine(dict(ECFG, paged=paged, speculative_k=2,
                                    **DRAFTS[draft]))
        return drive(jengine, eng, model()[0].vocab_size), spec_counts(eng)


@pytest.mark.parametrize("draft,paged,shards", [
    ("lanes", False, 2), ("lanes", True, 2), ("dense", False, 2),
    ("dense", True, 2), ("lanes", False, 4)])
def test_speculative_under_a_mesh_equals_one_shard(draft, paged, shards):
    """A speculative engine over a mesh: the draft's packed leaves split
    their columns and its caches their kv heads (a pool's page axis
    whole), as the target's do; the tokens and the acceptance counts are
    the one-shard speculative engine's and the reference's speculative
    engine's."""
    got, counts, eng = spec_serve(draft, paged, cpu_mesh(shards))
    want, want_counts = spec_one_shard(draft, paged)
    assert got == want and counts == want_counts
    assert (got, counts) == spec_reference(draft, paged)
    assert counts[2] > 0
    spec = eng.spec
    kv = lm.first_attn_cache(spec.caches)
    assert isinstance(kv["k"], sharding.Sharded)
    assert [p.shape[2] for p in kv["k"].parts] == \
        [spec.cfg.num_kv_heads // shards] * shards
    if paged:
        assert all(p.shape[0] == spec.num_pages for p in kv["k"].parts)
    word = "w_dense" if draft == "dense" else "w_packed"
    leaf = spec.params["layers"][0]["attn"]["q"][word]
    assert isinstance(leaf, sharding.Sharded)
    assert len(leaf.parts) == shards
    rep = eng.capacity_report()["speculative"]["draft_shard_param_bytes"]
    assert len(set(rep["split"])) == 1 and rep["split"][0] > 0
    assert not eng.capacity_report()["step_graphs"]   # the CPU: eager


def test_router_of_speculative_sharded_replicas():
    """A Router over a (data=2, model=2) mesh of cpu devices with
    ``speculative_k=2``: each row one speculative replica split two ways;
    the fleet's tokens are one unsharded speculative engine's and the
    reference's speculative engine's."""
    from repro_torch.serve.router import Router
    cfg, params = model()
    spec = dict(ECFG, speculative_k=2, **DRAFTS["lanes"])
    ecfg = EngineConfig(**spec)
    one = ServingEngine(cfg, params, device="cpu", config=ecfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 11, 5)]
    reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        one.submit(r)
    one.run_to_completion()
    with jax.disable_jit():
        ref = reference_engine(spec)
        jreqs = [jengine.Request(i, p, max_new_tokens=5)
                 for i, p in enumerate(prompts)]
        for r in jreqs:
            ref.submit(r)
        ref.run_to_completion()
    assert [list(r.output) for r in reqs] == \
        [list(r.output) for r in jreqs]
    router = Router(cfg, params, config=ecfg,
                    mesh=ServingMesh([["cpu", "cpu"], ["cpu", "cpu"]]))
    handles = [router.submit(p, max_new_tokens=5) for p in prompts]
    router.run_to_completion()
    assert [h.output for h in handles] == [r.output for r in reqs]
    assert sorted({h.replica for h in handles}) == [0, 1]
    for eng in router.engines:
        assert eng.spec is not None and eng.metrics.spec_cycles > 0
        assert eng.shard_plan.model_shards == 2


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


@pytest.mark.parametrize("name,kv_bits,paged", [
    pytest.param("jamba-1.5-large-398b", 16, False, id="16-False"),
    pytest.param("jamba-1.5-large-398b", 8, False, id="8-False"),
    pytest.param("stablelm-1.6b", 4, True, id="4-True"),
    pytest.param("jamba-1.5-large-398b", 2, False, id="2-False"),
    pytest.param("xlstm-1.3b", 16, False, id="xlstm")])
def test_cache_shardings_agree_with_the_reference(name, kv_bits, paged):
    """Every cache leaf splits over 'model' on the reference's axis: the
    attention K/V and scale planes on axis 2 (the kv heads) -- the page
    axis of a pool stays whole --, mamba's conv on 2 and ssm on 1, the
    mLSTM's C and n and the sLSTM's states on 2; the mLSTM's m stays
    whole."""
    from repro.parallel import sharding as jsharding
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
    got = sharding.cache_shardings(tc, cfg, cpu_mesh(tp), 3,
                                   kv_head_shard=True, paged=paged)
    got_flat = dict(_flat(got, spec_leaves=True))
    assert len(got_flat) == len(list(_flat(want)))
    axes = {}
    for path, sh in _flat(want):
        ref_axis = _model_axis(sh.spec)
        assert _model_axis(got_flat[path]) == ref_axis, path
        axes[path.rsplit("/", 1)[-1] if "attn" in path
             else "/".join(path.split("/")[-2:])] = ref_axis
    want_axes = {"attn": {"k": 2, "v": 2},
                 "mamba": {"mamba/conv": 2, "mamba/ssm": 1},
                 "xlstm": {"mlstm/C": 2, "mlstm/n": 2, "mlstm/m": None,
                           "slstm/c": 2, "slstm/h": 2}}
    kinds = ["xlstm"] if name == "xlstm-1.3b" else \
        ["attn", "mamba"] if name.startswith("jamba") else ["attn"]
    for kind in kinds:
        for leaf, axis in want_axes[kind].items():
            assert axes[leaf] == axis, leaf


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
