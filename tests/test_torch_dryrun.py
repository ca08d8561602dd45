"""The port's input shapes and dry run (``repro_torch.launch.shapes``,
``launch/dryrun.py``) against the reference's: every input spec's shapes
and dtypes equal to ``repro.launch.shapes``'s ``ShapeDtypeStruct``s (the
port's are ``meta`` tensors) and ``cell_is_live`` equal for every arch x
shape; ``lower_cell`` on one cell a family -- dense, MoE, hybrid,
recurrent, vision, encoder-decoder; train, prefill and decode, both
production meshes -- with its per-device argument bytes equal to the sum
of shard sizes from the reference's shardings over ``jax.eval_shape``
structs of the same arguments (the train state, or the serving params
packed for decode plus caches plus batch); the report's keys, SKIP
cells and the CLI."""

import json
import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shapes as shp  # noqa: E402
from repro_torch.roofline import analysis, hw  # noqa: E402

DT = {"int32": torch.int32, "bfloat16": torch.bfloat16,
      "float32": torch.float32, "int8": torch.int8, "int16": torch.int16}


@pytest.fixture(autouse=True)
def empty_caches():
    from repro.kernels import autotune as jautotune
    from repro_torch.kernels import autotune
    old, jold = autotune.active_cache(), jautotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)
    jautotune.set_active_cache(jold)


def _flat_ref(tree):
    return [(jsharding.path_str(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_input_specs_and_live_cells_equal(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for name in shp.SHAPES:
        assert shp.cell_is_live(arch, name)[0] == \
            jshapes.cell_is_live(arch, name)[0]
        assert vars(shp.SHAPES[name]) == vars(jshapes.SHAPES[name])
        got = tree_lib.flatten_with_path(shp.input_specs(cfg, name))
        want = _flat_ref(jshapes.input_specs(jcfg, name))
        assert [p for p, _ in got] == [p for p, _ in want], (arch, name)
        for (p, t), (_, j) in zip(got, want):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape), (arch, name, p)
            assert t.dtype == DT[str(j.dtype)], (arch, name, p)
    assert shp.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS


def _ref_bytes(tree, shardings, served=False):
    """One device's bytes of the reference's arguments, but its packed
    layers' ``k_full`` (an int32 0-d array a packed Dense there, a Python
    int in the port, on no device) and, in a ``served`` tree, the MoE
    experts' ``w_step`` (the port's prep derives the experts' lattices
    and drops the step)."""
    total = 0
    sh = dict(_flat_ref(jax.tree.map(
        lambda s: s, shardings, is_leaf=lambda x: isinstance(x,
                                                             NamedSharding))))
    for path, leaf in _flat_ref(tree):
        if path.endswith("/k_full") or (served and re.search(
                r"/moe/(up|gate|down)/w_step$", path)):
            continue
        n = 1
        for d in sh[path].shard_shape(tuple(leaf.shape)):
            n *= d
        total += n * leaf.dtype.itemsize
    return total


def _ref_arguments(arch, shape_name, mesh):
    """The reference dry run's arguments and shardings, by part."""
    cfg = jconfigs.get_config(arch)
    shape = jshapes.SHAPES[shape_name]
    gb = shape.global_batch
    key = jax.random.PRNGKey(0)
    if shape.kind == "train":
        st = jax.eval_shape(lambda: jsteps.make_train_state(
            jlm.init_params(key, cfg), cfg=cfg))
        batch = jshapes.input_specs(cfg, shape_name)
        p_sh = jsharding.param_shardings(st["params"], cfg, mesh)
        o_sh = jsharding.opt_state_shardings(st["opt_state"], p_sh, cfg,
                                             mesh)
        rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
        return {"params": (st["params"], p_sh),
                "opt_state": ((st["opt_state"], st["step"]), (o_sh, rep)),
                "batch": (batch, jsharding.batch_shardings(batch, cfg, mesh,
                                                           gb))}
    if shape.kind == "prefill":
        params = jax.eval_shape(lambda: jlm.init_params(key, cfg))
        batch = jshapes.input_specs(cfg, shape_name)
        return {"params": (params, jsharding.param_shardings(params, cfg,
                                                             mesh)),
                "batch": (batch, jsharding.batch_shardings(batch, cfg, mesh,
                                                           gb))}
    params = jax.eval_shape(lambda: jprepare.prepare_serving_params(
        jlm.init_params(key, cfg), cfg))
    specs = jshapes.input_specs(cfg, shape_name)
    rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
    return {"params": (params, jsharding.param_shardings(params, cfg, mesh)),
            "caches": (specs["caches"], jsharding.cache_shardings(
                specs["caches"], cfg, mesh, gb,
                sequence_parallel=(shape_name == "long_500k"))),
            "batch": ((specs["batch"], specs["index"]),
                      (jsharding.batch_shardings(specs["batch"], cfg, mesh,
                                                 gb), rep))}


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("stablelm-1.6b", "train_4k", False),
    ("mixtral-8x7b", "prefill_32k", False),
    ("jamba-1.5-large-398b", "decode_32k", True),
    ("xlstm-1.3b", "long_500k", False),
    ("qwen2-vl-2b", "train_4k", True),
    ("seamless-m4t-medium", "decode_32k", False)])
def test_lower_cell_bytes_equal_reference_shardings(arch, shape_name,
                                                    multi_pod):
    dims, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    jmesh = AbstractMesh(dims, axes)
    served = jshapes.SHAPES[shape_name].kind not in ("train", "prefill")
    want = {part: _ref_bytes(tree, sh, served and part == "params")
            for part, (tree, sh) in
            _ref_arguments(arch, shape_name, jmesh).items()}
    rep = dryrun.lower_cell(arch, shape_name, multi_pod)
    mem = rep["memory_analysis"]
    assert {k: mem[f"{k}_bytes"] for k in want} == want
    assert mem["argument_size_in_bytes"] == sum(want.values())
    cfg = configs.get_config(arch)
    chips = 512 if multi_pod else 256
    mflops = analysis.model_flops(cfg, shp.SHAPES[shape_name])
    assert rep["status"] == "PLACED" and rep["chips"] == chips
    assert rep["mesh"] == "x".join(map(str, dims))
    assert rep["model_flops"] == mflops
    assert rep["compute_s"] == mflops / chips / hw.PEAK_FLOPS_BF16
    assert rep["memory_s"] == sum(want.values()) / hw.HBM_BW
    assert rep["fits_hbm"] == (sum(want.values()) <= hw.HBM_PER_CHIP)
    assert rep["dominant"] in ("compute", "memory")
    assert not any(k.startswith("hlo_") or k == "collective_s"
                   for k in rep) and "lowered" in rep["reason"]
    counts = cfg.param_counts()
    assert (rep["param_count_total"], rep["param_count_active"]) == \
        (counts["total"], counts["active"])


def test_skip_cells_and_cli(tmp_path, capsys):
    rep = dryrun.lower_cell("stablelm-1.6b", "long_500k", False)
    assert rep["status"] == "SKIP" and rep["mesh"] == "16x16"
    assert rep["reason"] == jshapes.cell_is_live("stablelm-1.6b",
                                                 "long_500k")[1] or \
        rep["reason"].startswith("pure full-attention arch")
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "decode_32k",
                        "--kv-bits", "4", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["status"] == "PLACED" and rep["arch"] == "minicpm-2b"
    # the training layout splits K/V's last axis over 'model': head_dim
    # 64 at kv 16, but kv 4's 8 words a head do not divide 16 ways, so
    # the packed cache stays whole on every device (the reference's rule)
    kv16 = dryrun.lower_cell("minicpm-2b", "decode_32k", False, kv_bits=16)
    assert rep["memory_analysis"]["caches_bytes"] > \
        kv16["memory_analysis"]["caches_bytes"]
    assert dryrun.main(["--arch", "qwen1.5-32b", "--shape", "long_500k",
                        "--multi-pod"]) == 0
    assert '"SKIP"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-32b"])
