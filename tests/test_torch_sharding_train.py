"""The training half of the port's sharding rules
(``repro_torch.parallel.sharding``) against ``repro.parallel.sharding``:
every leaf's spec and its per-device shard shape equal, for
``param_shardings``, ``opt_state_shardings`` (f32 and 8-bit moments),
``batch_shardings`` (every shape's inputs) and each branch of
``cache_shardings`` (batch over DP, sequence-parallel long_500k, the
``REPRO_KV_SEQ_SHARD`` layout, the serving kv-head layout, paged pools),
for all ten archs at full width on ``jax.sharding.AbstractMesh((16, 16))``
and ``((2, 16, 16))`` -- the reference's production meshes -- and on a
(2, 2) mesh.  The reference's trees are ``jax.eval_shape`` structs, the
port's ``meta`` tensors.  A spec entry naming one axis compares as that
axis, as ``tuple(PartitionSpec)`` writes it.  An axis of size 1 splits
nothing: the port's batch entry leaves it out where the reference keeps
it, so on a mesh with such an axis the two compare with it read as None.
``constrain`` and ``constrain_like_params`` return their input."""

import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.launch import shapes as shp  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


class PortMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def meshes(name):
    dims, axes = MESHES[name]
    return AbstractMesh(dims, axes), PortMesh(zip(axes, dims))


def _pairs(tree, specs, path=()):
    """(path, leaf, spec) of a port tree and its spec tree, walked
    together (a tuple node of the tree pairs with a tuple of specs)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], specs[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, (t, s) in enumerate(zip(tree, specs)):
            yield from _pairs(t, s, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree, specs


def _ref(tree, shardings):
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    leaves = {jsharding.path_str(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    for p, sh in flat:
        ps = jsharding.path_str(p)
        if ps not in leaves:
            continue
        shape = tuple(leaves[ps].shape)
        out[ps] = (shape, tuple(sh.spec), tuple(sh.shard_shape(shape)))
    return out


def _port(tree, specs, mesh):
    return {p: (tuple(leaf.shape), spec,
                sharding.shard_shape(tuple(leaf.shape), spec, mesh))
            for p, leaf, spec in _pairs(tree, specs)}


def assert_same(got, want, what):
    assert got.keys() == want.keys(), (what, sorted(got.keys()
                                                    ^ want.keys())[:5])
    bad = [(p, got[p], want[p]) for p in want if got[p] != want[p]]
    assert not bad, (what, len(bad), bad[:3])


@functools.lru_cache(maxsize=None)
def params(arch):
    """(reference structs, port meta tensors) of the full-width params."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    return (jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                   jcfg)),
            lm.init_params(cfg, device="meta"))


def opt_states(arch, eightbit):
    """The optimizer states of :func:`params`: the packages' own ``init``
    for f32 moments; for 8-bit ones the moments' layout (``{"q": int8
    [blocks, 256], "scale": f32 [blocks, 1]}`` a leaf) built from the
    param shapes, which ``tests/test_torch_optim.py`` holds the two
    ``init``s to (tracing ``init`` over a 32B model takes ~10 s a
    side)."""
    jp, p = params(arch)
    if not eightbit:
        return (jax.eval_shape(lambda: jadamw.init(jp, jadamw.AdamWConfig())),
                adamw.init(p, adamw.AdamWConfig()))

    def blocks(shape):
        n = 1
        for d in shape:
            n *= d
        return -(-n // 256)

    def jm(leaf):
        b = blocks(leaf.shape)
        return {"q": jax.ShapeDtypeStruct((b, 256), "int8"),
                "scale": jax.ShapeDtypeStruct((b, 1), "float32")}

    def tm(leaf):
        b = blocks(leaf.shape)
        return {"q": torch.empty((b, 256), dtype=torch.int8, device="meta"),
                "scale": torch.empty((b, 1), device="meta")}

    def both(fn, tree, mapper):
        return {"m": mapper(fn, tree), "v": mapper(fn, tree)}

    jo = both(jm, jp, jax.tree.map)
    jo["count"] = jax.ShapeDtypeStruct((), "int32")
    to = both(tm, p, lambda f, t: tree_lib.tree_map(f, t))
    to["count"] = torch.empty((), dtype=torch.int32, device="meta")
    return jo, to


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_and_opt_state_specs_equal(arch, mesh_name):
    jmesh, mesh = meshes(mesh_name)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jparams, tparams = params(arch)
    jp = jsharding.param_shardings(jparams, jcfg, jmesh)
    p = sharding.param_shardings(tparams, cfg, mesh)
    assert_same(_port(tparams, p, mesh), _ref(jparams, jp), "params")
    for eightbit in (False, True):
        jo, to = opt_states(arch, eightbit)
        assert_same(
            _port(to, sharding.opt_state_shardings(to, p, cfg, mesh), mesh),
            _ref(jo, jsharding.opt_state_shardings(jo, jp, jcfg, jmesh)),
            f"opt_state eightbit={eightbit}")


@functools.lru_cache(maxsize=None)
def inputs(arch, name):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    return jshapes.input_specs(jcfg, name), shp.input_specs(cfg, name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_specs_equal(arch, mesh_name, monkeypatch):
    jmesh, mesh = meshes(mesh_name)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name, shape in shp.SHAPES.items():
        gb = shape.global_batch
        jspecs, specs = inputs(arch, name)
        if shape.kind != "decode":
            assert_same(
                _port(specs, sharding.batch_shardings(specs, cfg, mesh, gb),
                      mesh),
                _ref(jspecs, jsharding.batch_shardings(jspecs, jcfg, jmesh,
                                                       gb)), (name, "batch"))
            continue
        assert_same(
            _port(specs["batch"], sharding.batch_shardings(
                specs["batch"], cfg, mesh, gb), mesh),
            _ref(jspecs["batch"], jsharding.batch_shardings(
                jspecs["batch"], jcfg, jmesh, gb)), (name, "batch"))
        sp = name == "long_500k"      # batch 1: the sequence over 'data'
        for kw, seq in ((dict(sequence_parallel=sp), "0"),
                        (dict(sequence_parallel=sp), "1"),
                        (dict(kv_head_shard=True), "0")):
            monkeypatch.setenv("REPRO_KV_SEQ_SHARD", seq)
            assert_same(
                _port(specs["caches"], sharding.cache_shardings(
                    specs["caches"], cfg, mesh, gb, **kw), mesh),
                _ref(jspecs["caches"], jsharding.cache_shardings(
                    jspecs["caches"], jcfg, jmesh, gb, **kw)),
                (name, kw, seq))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "jamba-1.5-large-398b",
                                  "qwen2-vl-2b"])
def test_paged_cache_specs_equal(arch):
    """Page pools: the page axis stays whole, the kv-head rule holds."""
    jmesh, mesh = meshes("2x2")
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    kw = dict(page_size=16, num_pages=8)
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, 4, 64, **kw))
    tc = lm.init_caches(cfg, 4, 64, device="meta", **kw)
    for shard in (True, False):
        assert_same(
            _port(tc, sharding.cache_shardings(tc, cfg, mesh, 4,
                                               kv_head_shard=shard,
                                               paged=True), mesh),
            _ref(jc, jsharding.cache_shardings(jc, jcfg, jmesh, 4,
                                               kv_head_shard=shard,
                                               paged=True)), shard)


def test_size_one_axes_compare_as_whole():
    """On a one-row serving mesh the reference puts 'data' (size 1) on
    the batch axis where the port has None; with that entry read as None
    every spec agrees."""
    jmesh = AbstractMesh((1, 4), ("data", "model"))
    mesh = PortMesh({"data": 1, "model": 4})
    arch = "stablelm-1.6b"
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, 4, 64))
    tc = lm.init_caches(cfg, 4, 64, device="meta")
    want = _ref(jc, jsharding.cache_shardings(jc, jcfg, jmesh, 4,
                                              kv_head_shard=True))
    got = _port(tc, sharding.cache_shardings(tc, cfg, mesh, 4,
                                             kv_head_shard=True), mesh)
    assert sharding.batch_pspec(cfg, mesh, 4) == (None,)
    assert tuple(jsharding.batch_pspec(jcfg, jmesh, 4)) == ("data",)
    for p, (shape, spec, per) in want.items():
        assert spec[0] == "data"
        assert got[p] == (shape, (None,) + spec[1:], per)


def test_production_mesh_and_hints():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    assert mp.devices is None
    cfg = configs.get_config("jamba-1.5-large-398b")   # FSDP over pods
    assert cfg.parallel.fsdp_over_pod
    assert sharding.param_pspec("layers/4/attn/q/kernel",
                                torch.empty(8192, 8192, device="meta"), cfg,
                                mp) == (("pod", "data"), "model")
    x = torch.ones(4, 4)
    with sharding.activation_mesh(mp) as m:
        assert m is mp
        assert sharding.constrain(x, "dp", None) is x
        tree = {"a": [x]}
        assert sharding.constrain_like_params(tree, cfg) is tree
