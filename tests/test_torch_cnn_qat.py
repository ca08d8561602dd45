"""The port's CNN QAT path against the reference at reduced size
(``sparq-cnn --reduced``, W2A2): ``conv_apply(quant_mode='qat')`` -- LSQ
weights, the PACT clip on ``alpha``, ``fake_quant`` at ``alpha / qmax``
-- and the whole network's loss and gradients, ``alpha``'s included, from
one parameter tree carried across by ``bridge``; then a few QAT steps of
``repro_torch.examples.train_cnn_qat`` on the CPU, its packed evaluation
on the prepared weights and plans.

The reference runs op by op (``jax.disable_jit``).  Tolerances: the
loss within 1e-5 relative and every gradient within 1e-4 relative plus
1e-6 absolute.  At W2A2 the QAT gradients hinge on the convolution's
summation order (lattice products cancel to zero at ReLU's kink and the
rails); on the CPU XLA's and PyTorch's f32 convolutions round alike on
these shapes, so the gradients agree, where two convolution algorithms
need not (the card test below).

Reference imports happen inside the ``ref`` fixture, so the card's
machine (no JAX) collects this file and runs its ``cuda`` test.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.examples import train_cnn_qat as example  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.models import cnn as jcnn
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 cnn=jcnn)


def _tree_pair(ref, seed=0):
    jcfg = ref.configs.get_config("sparq-cnn", reduced=True)
    jp = ref.cnn.init_params(ref.jax.random.PRNGKey(seed), jcfg)
    # a clip inside the activations' range, so PACT's rail is reached
    jp["layers"] = [dict(p, alpha=ref.jnp.float32(0.6 + 0.2 * i))
                    for i, p in enumerate(jp["layers"])]
    tcfg = tconfigs.get_config("sparq-cnn", reduced=True)
    return jcfg, tcfg, jp, bridge.from_repro(ref.jax.device_get(jp), "cpu")


def _images(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    hw = cfg.cnn_input_hw
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, cfg.cnn_num_classes, n).astype(np.int32))


def _close(got, want, name):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want),
                               rtol=1e-4, atol=1e-6, err_msg=name)


def test_conv_apply_qat_forward_and_grads(ref):
    jax, jnp = ref.jax, ref.jnp
    jcfg, tcfg, jp, tp = _tree_pair(ref)
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(size=(2, 8, 8, 8))).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    with jax.disable_jit():
        jy, vjp = jax.vjp(lambda p, a: ref.cnn.conv_apply(
            p, a, jcfg.quant, quant_mode="qat"), jp["layers"][0],
            jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(g))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tp["layers"][0].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = cnn.conv_apply(leaves, tx, tcfg.quant, quant_mode="qat")
    names = sorted(leaves)
    grads = torch.autograd.grad(ty, [leaves[k] for k in names] + [tx],
                                torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    assert float(jgp["alpha"]) != 0.0
    for k, gk in zip(names, grads):
        _close(gk, jgp[k], k)
    _close(grads[-1], jgx, "x")


def test_network_qat_loss_and_grads(ref):
    jax, jnp = ref.jax, ref.jnp
    jcfg, tcfg, jp, tp = _tree_pair(ref, seed=3)
    x, y = _images(tcfg)

    def jloss(p):
        logits = ref.cnn.forward(p, jcfg, jnp.asarray(x), quant_mode="qat",
                                 backend="xla")
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             1))

    with jax.disable_jit():
        jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = [p.detach().requires_grad_(True) for p in tree_lib.leaves(tp)]
    tl = example.loss_fn(tree_lib.unflatten(tp, leaves), tcfg,
                         torch.from_numpy(x), torch.from_numpy(y).long(),
                         "qat")
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    names = [n for n, _ in tree_lib.flatten_with_path(tp)]
    jleaves = ref.jax.tree.leaves(jg)
    assert len(names) == len(jleaves) == len(grads)
    alphas = 0
    for name, g, want in zip(names, grads, jleaves):
        if g is None:               # the stem's unused w_step and alpha
            assert not np.asarray(want).any(), name
            continue
        _close(g, want, name)
        alphas += name.endswith("alpha")
    assert alphas == len(tcfg.cnn_channels)


def test_example_trains_and_evaluates_packed():
    """A few QAT steps of the example on the CPU: finite falling losses,
    and the float, QAT and packed-integer accuracies over the held-out
    set, the packed one through prepared weights and layer plans (the
    plain K5 here, the tensor-core K5 on the card)."""
    cfg = tconfigs.get_config("sparq-cnn", reduced=True).replace(
        cnn_input_hw=12)
    rep = example.run(cfg, steps=12, batch=16, n_test=32, device="cpu",
                      log_every=0)
    assert all(np.isfinite(rep["losses"]))
    assert np.mean(rep["losses"][-3:]) < np.mean(rep["losses"][:3])
    for k in ("acc_float", "acc_qat", "acc_packed"):
        assert 0.0 <= rep[k] <= 1.0
    assert [p.backend for p in rep["plans"]] == ["torch"] * 2
    assert all("w_packed" in p for p in rep["packed"]["layers"])
    # the packed logits against the QAT forward's on the same weights
    xt, _ = rep["test"]
    with torch.no_grad():
        qat = cnn.forward(rep["params"], cfg, xt[:16], quant_mode="qat")
        packed = cnn.forward(rep["packed"], cfg, xt[:16],
                             quant_mode="packed", plans=rep["plans"])
    assert torch.isfinite(packed).all()
    assert float((qat - packed).abs().max()) < 1e-3 * float(
        qat.abs().max()) + 1e-3


@pytest.mark.cuda
def test_qat_step_on_the_card_matches_the_cpu():
    """The reduced CNN's loss and gradients on the card (cuDNN, TF32 off,
    as the train step runs them) against the port's CPU run on the same
    params and batch.  Float ('none'): loss within 1e-5 relative and every
    gradient within 1e-4 relative plus 1e-6 absolute (the convolutions sum
    in another order).  QAT: the loss within 1e-5 relative and every
    gradient finite on the same leaves; its gradients are not held
    element by element, because at W2A2 they hinge on the summation
    order: products of lattice values cancel to zero at ReLU's kink and at
    the lattices' rails, so two f32 convolution algorithms (cuDNN's, the
    CPU's) may part them while the loss agrees."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card")
    from repro_torch.models import common

    cfg = tconfigs.get_config("sparq-cnn", reduced=True)
    cpu = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    x, y = _images(cfg, n=8)
    names = [n for n, _ in tree_lib.flatten_with_path(cpu)]
    for mode in ("none", "qat"):
        out = {}
        for dev in ("cpu", "cuda"):
            leaves = [p.detach().to(dev).requires_grad_(True)
                      for p in tree_lib.leaves(cpu)]
            with common.full_f32():
                loss = example.loss_fn(
                    tree_lib.unflatten(cpu, leaves), cfg,
                    torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).long().to(dev), mode)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            out[dev] = (float(loss.detach()),
                        [None if g is None else g.cpu() for g in grads])
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                                   err_msg=mode)
        for name, a, b in zip(names, out["cuda"][1], out["cpu"][1]):
            assert (a is None) == (b is None), (mode, name)
            if a is None:
                continue
            assert torch.isfinite(a).all(), (mode, name)
            if mode == "none":
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=name)
