"""The port's optimizer (``optim/adamw.py``) and schedules
(``optim/schedules.py``) against the reference on the same numpy-seeded
params, gradients and steps.

AdamW runs three steps from one state with f32 and with 8-bit moments,
the reference op by op (``jax.disable_jit``).  Tolerances: params and f32
moments within 1e-6 relative (the bias corrections ``1 - b^t`` come from
each library's f32 ``pow``, which may differ by an ulp); the 8-bit
moments' scales within 1e-6 relative and their int8 lattices equal (m
and v are the same IEEE f32 ops on both sides -- the bias corrections
touch only the update -- and both round half to even, so even a tie of
``m / scale`` rounds alike).  Schedules are f32 on both sides: within 1e-6
relative (``cos`` / ``exp`` / ``log`` of the two libraries)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

RTOL = 1e-6


def _params(rng):
    """A tree with a padded leaf (407 values), a bf16 leaf, a 0-d step and
    an attention-like block holding a "q" key."""
    bf16 = ml_dtypes.bfloat16
    return {"a": rng.normal(size=(37, 11)).astype(np.float32),
            "b": rng.normal(size=(300,)).astype(bf16),
            "layers": [{"attn": {"q": {"kernel": rng.normal(
                                           size=(8, 64)).astype(np.float32),
                                       "w_step": np.float32(0.3)},
                                 "o": {"kernel": rng.normal(
                                           size=(64, 8)).astype(np.float32)}},
                        "norm": {"scale": rng.normal(size=(513,)).astype(
                            bf16)}}]}


def _grads(rng, params):
    return jax.tree.map(
        lambda p: (rng.normal(size=np.shape(p)) * 0.1).astype(p.dtype),
        params)


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("eightbit", [False, True])
def test_adamw_three_steps_against_reference(eightbit):
    rng = np.random.default_rng(3 + eightbit)
    params = _params(rng)
    jcfg = jadamw.AdamWConfig(eightbit_moments=eightbit)
    tcfg = tadamw.AdamWConfig(eightbit_moments=eightbit)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jadamw.init(jp, jcfg)
    tp = bridge.from_repro(params, device="cpu")
    tst = tadamw.init(tp, tcfg)
    for step in range(3):
        g = _grads(rng, params)
        lr = np.float32(1e-2 * (step + 1))
        with jax.disable_jit():
            ju, jst = jadamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    jnp.asarray(lr), jcfg)
            jp = jadamw.apply_updates(jp, ju)
        tu, tst = tadamw.update(bridge.from_repro(g, device="cpu"), tst, tp,
                                torch.tensor(lr), tcfg)
        tp = tadamw.apply_updates(tp, tu)
    assert int(tst["count"]) == int(jst["count"]) == 3
    assert tst["count"].dtype == torch.int32
    for (name, t), j in zip(tree_lib.flatten_with_path(tp),
                            jax.tree.leaves(jp)):
        assert t.dtype == bridge.from_repro(np.asarray(j), "cpu").dtype
        np.testing.assert_allclose(_f32(bridge.to_numpy(t)), _f32(j),
                                   rtol=RTOL, atol=1e-7, err_msg=name)
    for key in ("m", "v"):
        got = tree_lib.flatten_with_path(tst[key], is_leaf=tadamw.is_moment)
        want = jax.tree.leaves(jst[key], is_leaf=lambda x: isinstance(
            x, dict) and set(x) == {"q", "scale"})
        assert len(got) == len(want) == 6
        for (name, t), j in zip(got, want):
            if not eightbit:
                np.testing.assert_allclose(t.numpy(), _f32(j), rtol=RTOL,
                                           atol=1e-12, err_msg=name)
                continue
            assert tadamw.is_moment(t) and t["q"].dtype == torch.int8
            assert t["q"].shape == j["q"].shape == (
                -(-t["q"].numel() // 256), 256)
            np.testing.assert_allclose(t["scale"].numpy(), _f32(j["scale"]),
                                       rtol=RTOL, err_msg=name)
            np.testing.assert_array_equal(t["q"].numpy(), np.asarray(
                j["q"]), err_msg=name)

def test_moment_leaves_are_recognised_by_their_whole_key_set():
    assert tadamw.is_moment({"q": 1, "scale": 2})
    assert not tadamw.is_moment({"q": 1, "k": 2, "v": 3, "o": 4})
    assert not tadamw.is_moment({"q": 1})


def test_clip_by_global_norm_against_reference():
    rng = np.random.default_rng(9)
    g = _grads(rng, _params(rng))
    for max_norm in (0.1, 100.0):
        jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
        tg, tn = tadamw.clip_by_global_norm(
            bridge.from_repro(g, device="cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        for t, j in zip(tree_lib.leaves(tg), jax.tree.leaves(jg)):
            assert t.dtype == torch.float32 and j.dtype == jnp.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=1e-12)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_against_reference(name):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 89, 90, 95, 99, 100, 150):
        want = jsched.get_schedule(name)(jnp.int32(step), **kw)
        got = tsched.get_schedule(name)(torch.tensor(step,
                                                     dtype=torch.int32),
                                        **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   err_msg=f"{name} step {step}")
