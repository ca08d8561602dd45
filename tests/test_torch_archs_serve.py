"""The serving path of the three dense LM configs that ``chip_smoke.py``'s
``archs serve`` lines serve whole on the card -- granite-3-8b (GQA-4, a
tied head), minicpm-2b (a head count that is no power of two, a tied head
over a padded vocab) and qwen1.5-32b (QKV bias, an untied head) -- at
reduced size against the JAX reference, on the same bridged weights:
packed leaves byte-equal to ``repro``'s ``prepare_serving_params`` (lanes,
column sums, the QKV bias), the port's packed engine (the plain versions
on the CPU) against the reference's engine run op by op (greedy tokens
equal, the reference's own tokens asserted), and the card's
layer-at-a-time builder (``chip_smoke.build_packed_params``) equal leaf
for leaf to ``prepare_serving_params(lm.init_params(...))``.

The reduced sizes keep each config's distinguishing shapes: granite's
kv-head groups of 4 (a 16-token prefill chunk fills 64 query rows a kv
head, as at full width), minicpm's 6 heads and its vocab padded (500 ->
512, as 122,753 -> 122,880), granite's vocab padded too (509 -> 512),
qwen's nonzero QKV biases.
"""

import functools
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("granite-3-8b", "minicpm-2b", "qwen1.5-32b")
# reduced-size changes a config keeps its full-width traits with
SHAPES = {"granite-3-8b": dict(num_heads=8, num_kv_heads=2, vocab_size=509),
          "minicpm-2b": dict(num_heads=6, num_kv_heads=6, vocab_size=500),
          "qwen1.5-32b": {}}
ECFG = dict(max_batch=3, max_len=64, prefill_chunk=16)
PROMPTS = (5, 21, 17, 9)
NEW = 4


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty: the base lane layout."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(name, kv_bits):
    kw = dict(SHAPES[name], param_dtype="float32", compute_dtype="float32")
    out = []
    for mod in (jconfigs, tconfigs):
        c = mod.get_config(name, reduced=True)
        out.append(c.replace(quant=c.quant.replace(kv_bits=kv_bits), **kw))
    return tuple(out)


def _params(jcfg, seed=1):
    """The reference's init, QKV biases (zero at init) drawn nonzero; the
    same tree bridged to the port."""
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for layer in jp["layers"]:
            for n in ("q", "k", "v"):
                b = layer["attn"][n]["bias"]
                layer["attn"][n]["bias"] = jnp.asarray(
                    rng.normal(size=b.shape) * 0.1, b.dtype)
    return jp, bridge.from_repro(jp, device="cpu")


def _packed_pairs(jt, tt, path=""):
    """(path, reference leaf, port leaf) for every packed Dense of two
    serving trees of one layout."""
    if isinstance(jt, dict) and "w_packed" in jt:
        yield path, jt, tt
    elif isinstance(jt, dict):
        assert set(jt) == set(tt), path
        for k in jt:
            yield from _packed_pairs(jt[k], tt[k], f"{path}/{k}")
    elif isinstance(jt, (list, tuple)):
        assert len(jt) == len(tt), path
        for i, (a, b) in enumerate(zip(jt, tt)):
            yield from _packed_pairs(a, b, f"{path}[{i}]")


@pytest.mark.parametrize("name", NAMES)
def test_packed_leaves_byte_equal(name):
    """Every packed Dense of the port's serving tree holds the reference's
    bytes: the lanes, the column sums, the scales and zero points, and
    qwen1.5's QKV bias."""
    jcfg, tcfg = _cfgs(name, 4)
    jp, tp = _params(jcfg)
    jpk = jprepare.prepare_serving_params(jp, jcfg)
    tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
    pairs = list(_packed_pairs(jpk, tpk))
    assert len(pairs) == 7 * tcfg.num_layers
    for path, j, t in pairs:
        for key in ("w_packed", "col_sums", "w_scale", "w_zp", "a_scale",
                    "a_zp"):
            want = np.asarray(j[key])
            got = t[key].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (path, key)
            assert got.tobytes() == want.tobytes(), (path, key)
        assert ("bias" in t) == ("bias" in j) == (
            tcfg.qkv_bias and path.split("/")[-1] in ("q", "k", "v")), path
        if "bias" in t:
            assert t["bias"].numpy().tobytes() == np.asarray(
                j["bias"]).tobytes() and np.asarray(j["bias"]).any(), path
    assert ("lm_head" in tpk) == (not tcfg.tie_embeddings)
    assert tpk["embed"]["table"].shape[0] == tcfg.padded_vocab


def _serve(module, cfg, params, **kw):
    eng = module.ServingEngine(cfg, params, config=module.EngineConfig(
        **ECFG), **kw)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    reqs = [module.Request(i, p, max_new_tokens=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.submit(r)
    for _ in range(3):                 # later admissions ride mid-stream
        eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _served(name, kv_bits):
    """(port, reference op by op) greedy tokens on the same weights."""
    jcfg, tcfg = _cfgs(name, kv_bits)
    jp, tp = _params(jcfg)
    port = _serve(tengine, tcfg, tp, device="cpu")
    with jax.disable_jit():
        ref = _serve(jengine, jcfg, jp)
    return port, ref


@pytest.mark.parametrize("kv_bits", [16, 4])
@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_equal_reference(name, kv_bits):
    """Staggered admissions, 16-token prefill chunks with decode riders,
    ragged decode through three slots for four requests: the port's packed
    engine gives the reference engine's greedy tokens, every one inside
    the vocabulary (the pad columns never win)."""
    port, ref = _served(name, kv_bits)
    _, tcfg = _cfgs(name, kv_bits)
    assert [len(o) for o in ref] == [NEW] * len(PROMPTS)
    assert all(0 <= t < tcfg.vocab_size for o in ref for t in o)
    assert port == ref


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``__main__`` guard keeps the
    import free of side effects)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("name", NAMES)
def test_layer_at_a_time_build_equals_whole_build(name):
    """The card's layer-at-a-time builder draws in ``init_params``' order
    and packs each block as the whole-tree call does: the same paths,
    dtypes and bytes, leaf for leaf, at the shipped dtypes."""
    build = _chip_smoke().build_packed_params
    cfg = tconfigs.get_config(name, reduced=True).replace(
        **{k: v for k, v in SHAPES[name].items() if k == "vocab_size"})
    got = build(cfg, torch.Generator().manual_seed(0), "cpu")
    want = tprepare.prepare_serving_params(
        tlm.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu"), cfg, device="cpu")
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert torch.equal(g.view(torch.uint8) if g.dim() else g,
                               w.view(torch.uint8) if w.dim() else w), path
        else:
            assert g == w, path


def test_layer_at_a_time_build_refuses_other_stacks():
    """An encoder-decoder or a vision prefix is not a decoder-only text
    LM: the builder refuses it rather than drawing a different tree."""
    build = _chip_smoke().build_packed_params
    for name in ("seamless-m4t-medium", "qwen2-vl-2b"):
        with pytest.raises(ValueError, match="decoder-only text LM"):
            build(tconfigs.get_config(name, reduced=True),
                  torch.Generator().manual_seed(0), "cpu")
