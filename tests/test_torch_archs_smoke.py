"""The port's counterpart of ``tests/test_archs_smoke.py``: every LM arch
``repro_torch.models.lm.check_supported`` accepts (all ten LM configs;
the CNN runs through ``models/cnn.py``), at reduced size and f32, from the
reference's own init carried across the bridge, with the batches of
``data/pipeline.family_batch`` (``tests/test_archs_smoke.py::make_batch``
in numpy: qwen2-vl's image prefix and (t, h, w) ids, seamless's encoder
embeddings) -- the QAT forward's logits
within 1e-4 of the reference's and its aux loss within 1e-5 relative,
then one backward whose loss and gradients are finite.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge, configs as tconfigs, tree  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _supported(name) -> bool:
    cfg = tconfigs.get_config(name, reduced=True)
    if cfg.family == "cnn":
        return False
    try:
        tlm.check_supported(cfg)
    except NotImplementedError:
        return False
    return True


ARCHS = [n for n in tconfigs.ARCH_NAMES if _supported(n)]


def test_supported_archs():
    assert set(ARCHS) == {"stablelm-1.6b", "qwen1.5-32b", "granite-3-8b",
                          "minicpm-2b", "mixtral-8x7b", "mixtral-8x22b",
                          "jamba-1.5-large-398b", "xlstm-1.3b",
                          "qwen2-vl-2b", "seamless-m4t-medium"}
    assert set(tconfigs.ARCH_NAMES) == set(ARCHS)
    with pytest.raises(NotImplementedError, match="CNN"):
        tlm.check_supported(tconfigs.get_config("sparq-cnn", reduced=True))


def _setup(name, seed):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config(name, reduced=True).replace(**kw)
    tcfg = tconfigs.get_config(name, reduced=True).replace(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    batch, labels = pipeline.family_batch(jcfg,
                                          np.random.default_rng(seed))
    return jcfg, tcfg, jp, bridge.from_repro(jax.device_get(jp),
                                             device="cpu"), batch, labels


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    jcfg, tcfg, jp, tp, batch, labels = _setup(name, 0)
    with jax.disable_jit():
        jl, jaux, _ = jlm.forward(jp, jcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                                  quant_mode="qat")
    with torch.no_grad():
        tl, taux, _ = tlm.forward(tp, tcfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()},
                                  quant_mode="qat")
    assert tuple(tl.shape) == (2, labels.shape[1], tcfg.padded_vocab)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    loss, _ = tlm.loss_fn(tl, labels, taux)
    jloss, _ = jlm.loss_fn(jl, jnp.asarray(labels), jaux)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_one_grad_step_no_nans(name):
    _, tcfg, _, tp, batch, labels = _setup(name, 1)
    leaves = [p.requires_grad_(True) if p.is_floating_point() else p
              for p in tree.leaves(tp)]
    params = tree.unflatten(tp, leaves)
    logits, aux, _ = tlm.forward(params, tcfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                                 quant_mode="qat")
    loss, _ = tlm.loss_fn(logits, labels, aux)
    assert torch.isfinite(loss)
    wrt = [p for p in leaves if p.requires_grad]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    assert any(g is not None for g in grads)
    for g in grads:
        if g is not None:
            assert torch.isfinite(g).all()
