"""The port's collectives (``repro_torch.parallel.collectives``) against
``repro.parallel.collectives``: int8 gradient compression bit-equal
(``quantize_grad``, ``dequantize_grad`` and ``compress_grads_with_
feedback`` with and without a residual; both round half to even); the
reduced stablelm train step with ``compress_grads=True`` and error
feedback within ``tests/test_torch_train.py``'s f32 tolerances of the
reference's over 3 steps (the reference op by op, from one state carried
across by ``bridge``), but at the int8 grid's flips, which the test
bounds; ``all_gather_matmul`` on a CPU mesh listing one
device twice, against the reference's ring run on 2 forced host devices
in a subprocess (as ``tests/test_extras.py`` runs it), within 1e-5."""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import ParallelConfig as TP  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.data.pipeline import DataConfig, \
    SyntheticLMStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402
from repro_torch.parallel import collectives as tc  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def empty_port_cache():
    from repro_torch.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.configs.base import ParallelConfig
    from repro.core.quant import QuantConfig
    from repro.launch import steps
    from repro.models import lm
    from repro.parallel import collectives
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 ParallelConfig=ParallelConfig,
                                 QuantConfig=QuantConfig, steps=steps, lm=lm,
                                 collectives=collectives)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(1000,)).astype(np.float32),
         "b": [rng.normal(size=(7, 33)).astype(np.float32) * 1e-3,
               np.zeros((256,), np.float32)],
         "c": (rng.standard_cauchy(size=(3, 5, 17)) * 50).astype(np.float32)}
    # exact halves of a step land on ties (round half to even)
    g["a"][:8] = np.array([127, 63.5, -0.5, 0.5, 1.5, -2.5, 126.5, -127],
                          np.float32)
    g["b"][1][:4] = [-0.0, 0.0, 1e-30, -1e-30]
    return g


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_quantize_dequantize_bit_equal(ref):
    jnp, rc = ref.jnp, ref.collectives
    for leaf in tree_lib.leaves(_grads()):
        for block in (256, 64):
            q, s = tc.quantize_grad(torch.from_numpy(leaf), block)
            jq, js = rc.quantize_grad(jnp.asarray(leaf), block)
            _same(q, jq)
            _same(s, js)
            _same(tc.dequantize_grad(q, s, leaf.shape),
                  rc.dequantize_grad(jq, js, leaf.shape))


def test_compress_with_and_without_feedback_bit_equal(ref):
    jax, jnp, rc = ref.jax, ref.jnp, ref.collectives
    g0 = _grads(0)
    deq, st = tc.compress_grads_with_feedback(
        tree_lib.tree_map(torch.from_numpy, g0), {"x": 1})
    jdeq, jst = rc.compress_grads_with_feedback(
        jax.tree.map(jnp.asarray, g0), {"x": 1})
    assert st == {"x": 1} == jst
    for a, b in zip(tree_lib.leaves(deq), jax.tree.leaves(jdeq)):
        _same(a, b)
    # three steps carrying the residual
    state = {"error_feedback": tree_lib.tree_map(
        lambda a: torch.zeros(a.shape), g0), "step": 0}
    jstate = {"error_feedback": jax.tree.map(
        lambda a: jnp.zeros(a.shape), g0), "step": 0}
    for i in range(3):
        g = _grads(i)
        deq, state = tc.compress_grads_with_feedback(
            tree_lib.tree_map(torch.from_numpy, g), state)
        jdeq, jstate = rc.compress_grads_with_feedback(
            jax.tree.map(jnp.asarray, g), jstate)
        for a, b in zip(tree_lib.leaves(deq), jax.tree.leaves(jdeq)):
            _same(a, b)
        for a, b in zip(tree_lib.leaves(state["error_feedback"]),
                        jax.tree.leaves(jstate["error_feedback"])):
            _same(a, b)
        assert state["step"] == 0
    # lossless bookkeeping: compressed(g + e) + new_e == g + e
    g = {"w": torch.tensor([1.0, 2.0, 3.0])}
    d, s = tc.compress_grads_with_feedback(
        g, {"error_feedback": {"w": torch.tensor([0.5, 0.0, 0.0])}})
    torch.testing.assert_close(d["w"] + s["error_feedback"]["w"],
                               torch.tensor([1.5, 2.0, 3.0]), rtol=1e-6,
                               atol=0)


def _tcfg():
    c = tconfigs.get_config("stablelm-1.6b", reduced=True)
    return c.replace(param_dtype="float32", compute_dtype="float32",
                     quant=TQ(enabled=True, w_bits=2, a_bits=2, kv_bits=0),
                     parallel=TP(remat=c.parallel.remat,
                                 microbatches=c.parallel.microbatches))


def test_compressed_train_step_matches_reference(ref):
    """Three W2A2 QAT steps with compressed gradients and error feedback:
    loss, ce and grad_norm within 1e-5 relative over the carried states
    (``tests/test_torch_train.py``'s f32 tolerance).  Then each step from
    the reference's state: params and residuals within 1e-5, but where
    the int8 grid flips -- the two packages' f32 gradients differ in
    their last bits (the same 1e-5), and a value that close to a rounding
    tie of its block lands one step apart.  Such an element's residual
    then differs by one step of its block (at most twice the leaf's
    largest residual), and there are at most two a step."""
    jax, jnp = ref.jax, ref.jnp
    tcfg = _tcfg()
    jc = ref.configs.get_config("stablelm-1.6b", reduced=True)
    jcfg = jc.replace(param_dtype="float32", compute_dtype="float32",
                      quant=ref.QuantConfig(enabled=True, w_bits=2, a_bits=2,
                                            kv_bits=0),
                      parallel=ref.ParallelConfig(
                          remat=tcfg.parallel.remat,
                          microbatches=tcfg.parallel.microbatches))
    jparams = ref.lm.init_params(jax.random.PRNGKey(1), jcfg)
    jstate = ref.steps.make_train_state(jparams, cfg=jcfg,
                                        error_feedback=True)
    tstate = bridge.from_repro(jax.device_get(jstate), device="cpu")
    fresh = tsteps.make_train_state(tstate["params"], cfg=tcfg,
                                    error_feedback=True)
    assert sorted(fresh) == sorted(tstate) == \
        ["error_feedback", "opt_state", "params", "step"]
    for a, b in zip(tree_lib.leaves(fresh["error_feedback"]),
                    tree_lib.leaves(tstate["error_feedback"])):
        assert a.dtype == b.dtype == torch.float32 and not a.any() \
            and a.shape == b.shape
    jstep = ref.steps.make_train_step(jcfg, compress_grads=True, **KW)
    tstep = tsteps.make_train_step(tcfg, compress_grads=True, **KW)
    data = SyntheticLMStream(DataConfig(vocab_size=tcfg.vocab_size,
                                        seq_len=16, global_batch=4, seed=0))
    jstates = [jstate]
    for i in range(3):
        batch = data.batch_at(i)
        with jax.disable_jit():
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        jstates.append(jstate)
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    for i in range(3):
        got, _ = tstep(bridge.from_repro(jax.device_get(jstates[i]), "cpu"),
                       data.batch_at(i))
        want = bridge.from_repro(jax.device_get(jstates[i + 1]), "cpu")
        over = 0
        for e_got, e_want in zip(tree_lib.leaves(got["error_feedback"]),
                                 tree_lib.leaves(want["error_feedback"])):
            d = (e_got - e_want).abs()
            flips = d > 1e-5
            over += int(flips.sum())
            assert bool((d[flips] <= 2 * e_want.abs().max() * (1 + 1e-5)
                         ).all()), f"step {i}"
        assert over <= 2, f"step {i}: {over} flipped residuals"
        n_params = 0
        for x, y in zip(tree_lib.leaves(got["params"]),
                        tree_lib.leaves(want["params"])):
            n_params += int(((x - y).abs() > 1e-5).sum())
        assert n_params <= over, f"step {i}"
    assert any(float(e.abs().max()) > 0
               for e in tree_lib.leaves(tstate["error_feedback"]))


AGM_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.collectives import all_gather_matmul
    mesh = jax.make_mesh((2,), ("model",))
    d = np.load(sys.argv[1])
    y = all_gather_matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]), mesh,
                          axis="model")
    np.save(sys.argv[2], np.asarray(y))
    print("CM_OK")
""")


def test_all_gather_matmul_matches_reference(tmp_path):
    pytest.importorskip("jax")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, w=w)
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", AGM_SCRIPT,
                        str(tmp_path / "in.npz"), str(tmp_path / "y.npy")],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert "CM_OK" in r.stdout, (r.stdout[-1500:], r.stderr[-1500:])
    want = np.load(tmp_path / "y.npy")
    mesh = ServingMesh([["cpu", "cpu"]])
    xs = sharding.split(torch.from_numpy(x), (None, "model"),
                        mesh.devices[0])
    ws = sharding.split(torch.from_numpy(w), ("model", None),
                        mesh.devices[0])
    got = tc.all_gather_matmul(xs, ws, mesh, axis="model")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the accumulator is x's dtype, as the reference keeps it
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    yb = tc.all_gather_matmul(
        sharding.split(xb, (None, "model"), mesh.devices[0]),
        sharding.split(wb, ("model", None), mesh.devices[0]), mesh)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb, xb[:, :8] @ wb[:8] + xb[:, 8:] @ wb[8:],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="split 2 ways"):
        tc.all_gather_matmul(sharding.Sharded([xs.parts[0]], 1), ws, mesh)
