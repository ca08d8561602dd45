"""The xLSTM family's train step against the reference's
(``torch_train_reference.check_train_step``): xlstm-1.3b reduced (mLSTM
and sLSTM blocks), remat 'block', two microbatches, 8-token rows (the
reference's recurrences run step by step op by op); the mLSTM chunk's
gradient where the reference's overflows; and the CLI trainer."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_train_cases as cases  # noqa: E402
import torch_train_reference as reference  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402

ARCHS = ("xlstm-1.3b",)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty."""
    from repro_torch.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


@pytest.mark.parametrize("case", cases.cases(ARCHS), ids=cases.case_id)
def test_train_step_matches_reference(case):
    reference.check_train_step(*case)


@pytest.mark.parametrize("gap", [1.0, 100.0])
def test_mlstm_chunk_gradient_where_the_reference_overflows(gap):
    """One fresh-state mLSTM chunk of 6 tokens whose input gates rise by
    ``gap`` a token.  Above the diagonal the chunk's weight exponent is
    then ~``gap`` x (tau - t): the reference takes ``exp`` before it masks
    that triangle, so at gap 100 the exp overflows and the masked zero's
    gradient times inf is NaN (as xlstm-1.3b's train step at full width
    gave from its fourth layer down); the port masks the exponent.
    Output within 1e-5 relative of the reference's at both gaps (f32
    sums in another order); the gradients of q, k, v and both gates
    within 1e-5 at gap 1; at gap 100 the reference's gradient holds a
    NaN and the port's is finite."""
    rng = np.random.default_rng(0)
    b, nh, ln, hd = 1, 2, 6, 4
    q, k, v = (rng.normal(size=(b, nh, ln, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = (gap * np.arange(ln, dtype=np.float32)
             + rng.normal(size=(b, nh, ln)).astype(np.float32))
    g_log = -np.abs(rng.normal(size=(b, nh, ln))).astype(np.float32)
    cot = rng.normal(size=(b, nh, ln, hd)).astype(np.float32)
    args = (q, k, v, i_raw, g_log)

    def jfn(*a):
        state = (jnp.zeros((b, nh, hd, hd)), jnp.zeros((b, nh, hd)),
                 jnp.full((b, nh), -1e30))
        return jxlstm._mlstm_chunk(*a, state)[0]

    with jax.disable_jit():
        jy, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
        jg = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    state = ([torch.zeros(b, nh, hd, hd)], [torch.zeros(b, nh, hd)],
             torch.full((b, nh), -1e30))
    ty = txlstm._mlstm_chunk(*ts, state)[0]
    tg = torch.autograd.grad(ty, ts, torch.from_numpy(cot))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    assert all(torch.isfinite(g).all() for g in tg)
    if gap == 1.0:
        for name, a, want in zip(("q", "k", "v", "i", "f"), tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        assert not all(np.isfinite(np.asarray(g)).all() for g in jg)


@pytest.mark.parametrize("name", ARCHS)
def test_cli_trains_and_checkpoints(tmp_path, name):
    cases.cli_trains(tmp_path, name)
