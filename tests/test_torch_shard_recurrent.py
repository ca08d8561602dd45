"""Channel-split recurrent states under tensor-parallel serving in the port
(``parallel/sharding.cache_pspec``'s recurrent rules, ``models/mamba``'s
and ``models/xlstm``'s sharded recurrences, ``serve/shard.ShardPlan``'s
``Mirrored`` per-channel params) on the CPU.

A mesh of 2 or 4 ``cpu`` devices splits mamba's ``conv`` / ``ssm``, the
mLSTM's ``C`` / ``n`` and the sLSTM's four states by channel.  Reduced
jamba (mamba, attention and MoE in one stack) and reduced xlstm serve the
one-shard engine's tokens and the reference's single-device engine's
(its steps op by op, on the same weights bridged); the mamba states are
bit-equal to one shard's, the mLSTM and sLSTM states within
``sharding.CHANNEL_SPLIT_RTOL`` of the largest magnitude (their
contractions over the split axis become per-shard partial sums); a
block's cached call and its fresh-cache prefill over split states match
whole states; each shard holds only its slice; a slot reset writes each
part; a sharded replica drained and restored through the
Router serves a never-drained engine's tokens."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402
from repro_torch.models import lm, mamba, xlstm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serve import prepare  # noqa: E402
from repro_torch.serve.engine import (EngineConfig, Request,  # noqa: E402
                                      ServingEngine)
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch.serve.shard import ShardPlan  # noqa: E402

torch.set_num_threads(2)

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
RTOL = sharding.CHANNEL_SPLIT_RTOL
ECFG = dict(max_batch=3, max_len=48, prefill_chunk=4, page_size=16)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty (and the reference's)."""
    old, jold = autotune.active_cache(), jautotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)
    jautotune.set_active_cache(jold)


def cpu_mesh(n):
    return ServingMesh([["cpu"] * n])


QUANT = dict(enabled=True, w_bits=2, a_bits=2, lane_dtype="int16",
             kv_bits=4)


@functools.lru_cache(maxsize=None)
def model(name):
    cfg = configs.get_config(name, reduced=True).replace(
        quant=QuantConfig(**QUANT))
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu")


def requests(vocab, uid0=0, request=Request):
    rng = np.random.default_rng(5 + uid0)
    return [request(uid0 + i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=5)
            for i, n in enumerate((7, 3, 11, 5, 18))]


def drive(eng, vocab, request=Request):
    """Five staggered requests through three slots (chunked prefill with
    decode riders, two slots reused); ``request`` the engine's package's
    ``Request``."""
    reqs = requests(vocab, request=request)
    for r in reqs[:3]:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.output) for r in reqs]


def serve(name, mesh=None, paged=False):
    cfg, params = model(name)
    eng = ServingEngine(cfg, params, device="cpu", mesh=mesh,
                        config=EngineConfig(**ECFG, paged=paged))
    return drive(eng, cfg.vocab_size), eng


@functools.lru_cache(maxsize=None)
def one_shard(name, paged=False):
    got, eng = serve(name, paged=paged)
    return got, states(eng)


@functools.lru_cache(maxsize=None)
def reference(name, paged=False):
    """The reference's single-device engine on the same weights and
    requests, its steps op by op."""
    jcfg = jconfigs.get_config(name, reduced=True).replace(quant=JQ(**QUANT))
    jp = jax.tree.map(jnp.asarray, bridge.to_repro(model(name)[1]))
    with jax.disable_jit():
        eng = jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(
            **ECFG, paged=paged))
        return drive(eng, jcfg.vocab_size, jengine.Request)


def states(eng):
    """Every recurrent leaf, whole: {(layer, kind, name): tensor}."""
    return {(i, kind, n): sharding.whole(leaf).clone()
            for i, layer in enumerate(eng.caches)
            for kind, sub in layer.items() if kind in mamba_xlstm_kinds()
            for n, leaf in sub.items()}


def mamba_xlstm_kinds():
    return ("mamba", "mlstm", "slstm")


def assert_states_close(got, want):
    """Mamba states bit-equal; mLSTM / sLSTM states within RTOL of each
    leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if key[1] == "mamba":
            assert torch.equal(g, w), key
        else:
            scale = float(w.abs().max()) or 1.0
            assert float((g - w).abs().max()) <= RTOL * scale, key


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shards,paged", [
    (JAMBA, 2, False), (JAMBA, 4, False), (JAMBA, 2, True),
    (XLSTM, 2, False), (XLSTM, 4, False)])
def test_sharded_recurrent_tokens_equal_one_shard(name, shards, paged):
    got, eng = serve(name, cpu_mesh(shards), paged=paged)
    want, want_states = one_shard(name, paged)
    assert got == want
    assert got == reference(name, paged)
    assert all(len(o) == 5 for o in got)
    assert_states_close(states(eng), want_states)
    split = [leaf for _, leaf in sharding_leaves(eng.caches)
             if isinstance(leaf, sharding.Sharded)]
    assert split and all(len(leaf.parts) == shards for leaf in split)


def sharding_leaves(caches):
    for i, layer in enumerate(caches):
        for kind, sub in layer.items():
            if kind in mamba_xlstm_kinds():
                for n, leaf in sub.items():
                    yield (i, kind, n), leaf


@pytest.mark.parametrize("name", [JAMBA, XLSTM])
@pytest.mark.parametrize("shards", [2, 4])
def test_each_shard_holds_its_channel_slice(name, shards):
    """Each state's parts are its channel slices (the reference's axis),
    contiguous; the mLSTM's m stays whole; the capacity report's bytes a
    slot by shard add up to the one-shard figure, each shard holding
    1 / n of the split states."""
    cfg, _ = model(name)
    _, eng = serve(name, cpu_mesh(shards))
    axes = {("mamba", "conv"): 2, ("mamba", "ssm"): 1, ("mlstm", "C"): 2,
            ("mlstm", "n"): 2, ("mlstm", "m"): None, ("slstm", "c"): 2,
            ("slstm", "n"): 2, ("slstm", "h"): 2, ("slstm", "m"): 2}
    split_bytes = whole_bytes = 0
    for (_, kind, n), leaf in sharding_leaves(eng.caches):
        axis = axes[(kind, n)]
        if axis is None:
            assert isinstance(leaf, torch.Tensor)
            whole_bytes += leaf.numel() * 4
            continue
        assert isinstance(leaf, sharding.Sharded) and leaf.axis == axis
        whole = leaf.whole()
        w = whole.shape[axis] // shards
        for i, part in enumerate(leaf.parts):
            assert part.is_contiguous() and part.shape[axis] == w
            assert torch.equal(part, whole.narrow(axis, i * w, w))
        split_bytes += whole.numel() * 4
    rep = eng.capacity_report()["shard_plan"]["recurrent_bytes_per_slot"]
    b = eng.max_batch
    assert rep["split"] == [split_bytes // shards // b] * shards
    assert rep["whole"] == whole_bytes // b
    assert rep["one_shard"] == (split_bytes + whole_bytes) // b
    assert rep["per_shard"] == [rep["whole"] + rep["split"][0]] * shards
    one = ServingEngine(cfg, model(name)[1], device="cpu",
                        config=EngineConfig(**ECFG))
    if name == XLSTM:        # attention-free: a slot's cache is its states
        assert rep["one_shard"] == one.cache_bytes_per_slot
    assert "shard_plan" not in one.capacity_report()


def test_per_channel_params_are_mirrored():
    """The whole per-channel params keep the reference's (whole) spec; the
    shards read views of them on the home device, and on another device a
    copy made at placement, counted in the shard's bytes."""
    cfg, params = model(JAMBA)
    tpk = prepare.prepare_serving_params(params, cfg, device="cpu")
    placed = ShardPlan(cpu_mesh(2)).place_params(tpk)
    p = placed["layers"][0]["mamba"]
    for name in ("conv_w", "conv_b", "A_log", "D"):
        leaf = p[name]
        assert isinstance(leaf, sharding.Mirrored) and leaf.parts == (None,
                                                                     None)
        view = sharding.channel_part(p, name, 1, 2, torch.device("cpu"))
        assert view.untyped_storage().data_ptr() == \
            leaf.whole.untyped_storage().data_ptr()
        axis = sharding.CHANNEL_LEAVES[name]
        w = leaf.whole.shape[axis] // 2
        assert torch.equal(view, leaf.whole.narrow(axis, w, w))
    xcfg, xparams = model(XLSTM)
    xpk = ShardPlan(cpu_mesh(4)).place_params(
        prepare.prepare_serving_params(xparams, xcfg, device="cpu"))
    r = xpk["layers"][1]["slstm"]["r_gates"]
    assert isinstance(r, sharding.Mirrored)
    nh, hd = xcfg.num_heads, xcfg.d_model // xcfg.num_heads
    part = sharding.channel_part(xpk["layers"][1]["slstm"], "r_gates", 2,
                                 4, torch.device("cpu"))
    want = r.whole.view(nh, hd, 4, hd)[..., 2 * hd // 4:3 * hd // 4]
    assert torch.equal(part, want)
    # a shard on another device: the copy is made once, at placement
    other = ShardPlan(ServingMesh([["cpu", "meta"]]))
    far = other.place_params(tpk)
    leaf = far["layers"][0]["mamba"]["A_log"]
    assert leaf.parts[0] is None and leaf.parts[1].device.type == "meta"
    assert tuple(leaf.parts[1].shape) == (cfg.ssm_expand * cfg.d_model // 2,
                                          cfg.ssm_state_dim)
    near = ShardPlan(cpu_mesh(2)).shard_param_bytes(placed)
    got = other.shard_param_bytes(far)
    copies = sum(
        t.numel() * t.element_size()
        for layer in far["layers"] if "mamba" in layer
        for t in (layer["mamba"][n].parts[1]
                  for n in ("conv_w", "conv_b", "A_log", "D")))
    assert got["split"][1] == near["split"][1] + copies
    assert got["whole"] == near["whole"]
    assert prepare.serving_param_bytes(far) == \
        prepare.serving_param_bytes(placed) + copies


def test_slot_reset_writes_each_part():
    """``_reset_slot`` restores the slot's row of every part to the fresh
    state (the mLSTM's and sLSTM's m at -1e30), in place, and leaves the
    other rows alone."""
    _, eng = serve(XLSTM, cpu_mesh(2))
    ptrs = [p.data_ptr() for _, leaf in sharding_leaves(eng.caches)
            for p in sharding.parts(leaf)]
    before = states(eng)
    eng._reset_slot(1)
    after = states(eng)
    assert ptrs == [p.data_ptr() for _, leaf in sharding_leaves(eng.caches)
                    for p in sharding.parts(leaf)]
    for key, val in after.items():
        fresh = -1e30 if key[2] == "m" else 0.0
        assert torch.all(val[1] == fresh), key
        assert torch.equal(val[0], before[key][0])
        assert torch.equal(val[2], before[key][2])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

APPLY = {"mamba": mamba.mamba_apply, "mlstm": xlstm.mlstm_apply,
         "slstm": xlstm.slstm_apply}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("shards", [2, 4])
def test_block_over_split_states_matches_one_shard(kind, shards):
    """One cached block call, windows of 1 and 4 tokens with ragged valid
    counts (a dead row among them), on the same inputs and states, the
    params placed as the engine places them: over channel-split states
    the output and the states are mamba's bit for bit, the xLSTM's within
    RTOL."""
    name = JAMBA if kind == "mamba" else XLSTM
    cfg, params = model(name)
    layer = next(i for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) == kind)
    p = params["layers"][layer][kind]
    gen = torch.Generator().manual_seed(11)
    plan = ShardPlan(cpu_mesh(shards))
    placed = plan.place_params(params)["layers"][layer][kind]
    for s, valid in ((1, [1, 0, 1]), (4, [4, 2, 0])):
        x = torch.randn((3, s, cfg.d_model), generator=gen)
        whole = lm.init_recurrent_cache(cfg, kind, 3)
        for leaf in whole.values():       # a state already under way
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
        split = plan.place_caches({kind: {k: v.clone()
                                          for k, v in whole.items()}})[kind]
        cv = torch.tensor(valid, dtype=torch.int32)
        kw = dict(quant_mode="none", cache_index=torch.zeros(3),
                  cache_valid=cv)
        want, _ = APPLY[kind](p, cfg, x, cache=whole, **kw)
        got, _ = APPLY[kind](placed, cfg, x, cache=split, **kw)
        assert any(isinstance(v, sharding.Sharded) for v in split.values())
        got_states = {("b", kind, k): sharding.whole(v)
                      for k, v in split.items()}
        assert_states_close(got_states, {("b", kind, k): v
                                         for k, v in whole.items()})
        if kind == "mamba":
            assert torch.equal(got, want)
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_fresh_prefill_over_split_states_matches_one_shard(kind):
    """The prefill of a fresh cache (no ``cache_index``) over channel-split
    states: each part is reset to the fresh state and takes its slice of
    the window's final state, as the whole states do; the output and the
    states are mamba's bit for bit, the xLSTM's within RTOL."""
    name = JAMBA if kind == "mamba" else XLSTM
    cfg, params = model(name)
    layer = next(i for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) == kind)
    plan = ShardPlan(cpu_mesh(2))
    placed = plan.place_params(params)["layers"][layer][kind]
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((3, 5, cfg.d_model), generator=gen)
    whole = lm.init_recurrent_cache(cfg, kind, 3)
    for leaf in whole.values():           # stale values the prefill resets
        leaf.copy_(torch.rand(leaf.shape, generator=gen))
    split = plan.place_caches({kind: {k: v.clone()
                                      for k, v in whole.items()}})[kind]
    want, _ = APPLY[kind](params["layers"][layer][kind], cfg, x,
                          cache=whole)
    got, _ = APPLY[kind](placed, cfg, x, cache=split)
    assert_states_close({("b", kind, k): sharding.whole(v)
                         for k, v in split.items()},
                        {("b", kind, k): v for k, v in whole.items()})
    if kind == "mamba":
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RTOL * scale


# ---------------------------------------------------------------------------
# The Router
# ---------------------------------------------------------------------------

def test_sharded_recurrent_replica_drains_and_restores(tmp_path):
    """A paged reduced-jamba replica split two ways (its mamba states by
    channel, its pools by kv head) is drained to a checkpoint -- its states
    and pools written whole -- and restored onto its mesh row; it then
    serves the tokens of an engine that was never drained."""
    cfg, params = model(JAMBA)
    ecfg = EngineConfig(**ECFG, paged=True)
    never = ServingEngine(cfg, params, device="cpu", config=ecfg)
    rounds = (requests(cfg.vocab_size), requests(cfg.vocab_size, 100))
    want = []
    for reqs in rounds:
        for r in reqs:
            never.submit(r)
        never.run_to_completion()
        want.append([list(r.output) for r in reqs])
    router = Router(cfg, params, config=ecfg, mesh=cpu_mesh(2),
                    checkpoint_dir=tmp_path)
    got = []
    for i, reqs in enumerate(rounds):
        handles = [router.submit(r.prompt, max_new_tokens=5) for r in reqs]
        router.run_to_completion()
        got.append([list(h.output) for h in handles])
        if i == 0:
            info = router.drain(0)
            assert info["checkpoint"] is not None
            eng = router.restore(0)
    assert got == want
    conv = next(c["mamba"]["conv"] for c in eng.caches if "mamba" in c)
    assert isinstance(conv, sharding.Sharded) and len(conv.parts) == 2
