"""Checkpoints across the packages (ROADMAP.md Queue 1 item 8a): a train
state written by the reference's ``train/checkpoint.py`` is read by the
port's, and the other way, leaf by leaf -- names, dtypes and every bit,
bf16 leaves and 8-bit moment dicts included; a reference checkpoint packs
through the port into a serving tree byte-equal to the reference's
``prepare_serving_params``; and the port's own save / restore semantics
(async save, the commit marker, garbage collection, refusals)."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import prepare as jprepare  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture(autouse=True)
def base_layouts():
    """The reference packs in the config's base layout (an empty tuning
    cache), the only layout the port serves."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _reference_state(eightbit: bool, seed: int = 0):
    """A reduced W2A2 stablelm train state of the reference, bf16 params,
    after one AdamW update, so the moments are not all zero."""
    cfg = jconfigs.get_config("stablelm-1.6b", reduced=True)
    params = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    acfg = jadamw.AdamWConfig(eightbit_moments=eightbit)
    state = jsteps.make_train_state(params, acfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)
    _, opt = jadamw.update(grads, state["opt_state"], params,
                           jnp.float32(1e-3), acfg)
    state.update(opt_state=opt, step=jnp.int32(7))
    return cfg, state


def _leaves_equal(port_state, ref_state):
    """Leaf by leaf in the reference's order: names, dtypes, shapes and
    bytes."""
    got = tree_lib.flatten_with_path(port_state)
    ref = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert len(got) == len(ref) > 50
    dtypes = set()
    for (name, t), (path, want) in zip(got, ref):
        want = np.asarray(want)
        assert name == "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                                for e in path)
        assert isinstance(t, torch.Tensor), name
        back = bridge.to_repro(t)
        assert back.dtype == want.dtype and back.shape == want.shape, name
        assert back.tobytes() == want.tobytes(), name
        dtypes.add(str(want.dtype))
    return dtypes


@pytest.mark.parametrize("eightbit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, eightbit):
    _, state = _reference_state(eightbit)
    jckpt.save(tmp_path, state, step=7, extra={"config_name": "x"})
    got, manifest = tckpt.restore(tmp_path, device="cpu")
    assert manifest["step"] == 7 and manifest["config_name"] == "x"
    dtypes = _leaves_equal(got, state)
    assert {"bfloat16", "float32", "int32"} <= dtypes
    if eightbit:
        assert "int8" in dtypes
        m = got["opt_state"]["m"]["layers"][0]["attn"]["q"]["kernel"]
        assert set(m) == {"q", "scale"} and m["q"].dtype == torch.int8
    # the same leaves through a template of the port's own structure
    again, _ = tckpt.restore(tmp_path, got, device="cpu")
    _leaves_equal(again, state)


@pytest.mark.parametrize("eightbit", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, eightbit):
    _, state = _reference_state(eightbit, seed=1)
    port = bridge.from_repro(jax.device_get(state), device="cpu")
    tckpt.save(tmp_path, port, step=7, extra={"data_state": {"seed": 0}})
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(state))
    template = jax.eval_shape(lambda: state)
    restored, _ = jckpt.restore(tmp_path, template)
    _leaves_equal(port, restored)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_packs_byte_equal(tmp_path):
    """Item 8a's acceptance: the reference's params checkpoint, read by the
    port and packed by ``serve/prepare.py``, equals the reference's packed
    tree leaf by leaf, byte for byte."""
    cfg, state = _reference_state(False, seed=2)
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True)
    jckpt.save(tmp_path, state["params"], step=1)
    params, _ = tckpt.restore(tmp_path, device="cpu")
    want = jax.device_get(jprepare.prepare_serving_params(state["params"],
                                                          cfg))
    got = tprepare.prepare_serving_params(params, tcfg, device="cpu")
    got_l = tree_lib.flatten_with_path(got)
    want_l = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_l) == len(want_l) > 50
    packed = 0
    for (name, g), (_, w) in zip(got_l, want_l):
        if isinstance(g, int):
            assert g == int(w), name
            continue
        w = np.asarray(w)
        g = bridge.to_repro(g)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
        packed += name.endswith("w_packed")
    assert packed == 2 * 7


def test_round_trip_async_and_bf16_bits(tmp_path):
    state = {"params": {"w": torch.randn(8, 4).to(torch.bfloat16),
                        "layers": [{"a": torch.ones(3)},
                                   {"a": torch.zeros(3, dtype=torch.int8)}]},
             "step": torch.tensor(17, dtype=torch.int32)}
    join = tckpt.save(tmp_path, state, step=17, async_=True)
    join()
    assert tckpt.latest_step(tmp_path) == 17
    got, manifest = tckpt.restore(tmp_path, state, device="cpu")
    assert [(leaf["name"], leaf["dtype"]) for leaf in manifest["leaves"]] \
        == [("params/layers/0/a", "float32"), ("params/layers/1/a", "int8"),
            ("params/w", "bfloat16"), ("step", "int32")]
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_uncommitted_ignored_gc_and_mismatch(tmp_path):
    state = {"w": torch.zeros(2), "b": torch.ones(1)}
    for s in (1, 2, 3, 4):
        tckpt.save(tmp_path, state, step=s)
    d = tmp_path / "step_9"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    assert tckpt.latest_step(tmp_path) == 4
    tckpt.garbage_collect(tmp_path, keep=2)
    assert tckpt.latest_step(tmp_path) == 4
    assert not (tmp_path / "step_2").exists()
    assert (tmp_path / "step_3").exists()
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.restore(tmp_path, {"w": 0, "c": 0}, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", device="cpu")
