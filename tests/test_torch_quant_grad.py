"""The port's fake-quant autograd Functions (``core/quant.py``:
``fake_quant``, ``lsq_fake_quant``, ``pact_clip``) against ``jax.vjp`` of
the reference's custom VJPs on the same numpy-seeded inputs, in f32 and
bf16, and ``dense_apply(quant_mode='qat')`` with its gradients.

Tolerances: forward values and the elementwise input gradients are
bit-equal (the same IEEE ops in the same order, rounding half to even on
both sides, bf16 rounded after every op on both sides); the reduced
gradients (LSQ's step, PACT's alpha) are sums whose order differs between
XLA and PyTorch: within 1e-5 relative (f32 sums in both dtypes)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

SUM_RTOL = 1e-5
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    npd, jd, _ = DTYPES[dtype]
    a = np.asarray(a, np.float32).astype(npd)
    return jnp.asarray(a, jd), bridge.from_repro(a, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x.detach())
    return np.asarray(x, np.float32)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _close(got, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-30)


def _inputs(seed, shape=(6, 40)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 1.5).astype(np.float32), \
        rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("signed", [True, False])
def test_lsq_fake_quant_forward_and_grads(dtype, bits, signed):
    x, g = _inputs(bits + 10 * signed)
    step0 = 0.37 if signed else 0.21
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    jstep, tstep = _pair(np.float32(step0), dtype)
    jy, vjp = jax.vjp(lambda a, s: jquant.lsq_fake_quant(a, s, bits, signed),
                      jx, jstep)
    jdx, jds = vjp(jg)
    tx.requires_grad_(True)
    tstep.requires_grad_(True)
    ty = tquant.lsq_fake_quant(tx, tstep, bits, signed)
    tdx, tds = torch.autograd.grad(ty, (tx, tstep), tg)
    assert ty.dtype == tx.dtype and tds.dtype == tstep.dtype
    _equal(ty, jy)
    _equal(tdx, jdx)
    _close(tds, jds)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 3])
def test_fake_quant_forward_and_grads(dtype, bits):
    x, g = _inputs(20 + bits)
    x = np.abs(x) - 0.2                  # both rails and the inside
    jx, tx = _pair(x, dtype)
    jscale, tscale = _pair(np.float32(0.31), "float32")
    jzp, tzp = _pair(np.float32(1.0), "float32")
    jy, vjp = jax.vjp(lambda a, s, z: jquant.fake_quant(a, s, z, bits),
                      jx, jscale, jzp)
    jg = jnp.asarray(g, jy.dtype)
    jdx, jds, jdz = vjp(jg)
    tx.requires_grad_(True)
    tscale.requires_grad_(True)
    ty = tquant.fake_quant(tx, tscale, tzp, bits)
    assert ty.dtype == torch.float32
    tdx, tds = torch.autograd.grad(ty, (tx, tscale),
                                   torch.from_numpy(g))
    _equal(ty, jy)
    _equal(tdx, jnp.asarray(jdx, jx.dtype))
    assert float(tds) == 0.0 and float(jds) == 0.0 and float(jdz) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pact_clip_forward_and_grads(dtype):
    x, g = _inputs(31)
    x[0, :4] = 1.25                      # exactly at alpha
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    jalpha, talpha = _pair(np.float32(1.25), dtype)
    jy, vjp = jax.vjp(lambda a, al: jquant.pact_clip(a, al, 2), jx, jalpha)
    jdx, jda = vjp(jg)
    tx.requires_grad_(True)
    talpha.requires_grad_(True)
    ty = tquant.pact_clip(tx, talpha, 2)
    tdx, tda = torch.autograd.grad(ty, (tx, talpha), tg)
    _equal(ty, jy)
    _equal(tdx, jdx)
    _close(tda, jda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_apply_qat_forward_and_grads(dtype):
    """One QAT Dense at W2A2: the output and the gradients of the kernel,
    w_step, a_step and the input against ``jax.vjp`` of the reference's
    ``dense_apply(quant_mode='qat')``.  f32: the matmul sums in another
    order (within 1e-5 relative, 1e-6 absolute); bf16: the product rounds
    to bf16 (within 2^-7 relative plus 1e-2 absolute on gradients that
    cancel)."""
    npd, jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    jq, tq = JQ(enabled=True, w_bits=2, a_bits=2), TQ(enabled=True, w_bits=2,
                                                      a_bits=2)
    jp = jcommon.dense_init(jax.random.PRNGKey(1), 48, 24, dtype=jd,
                            quantized=True, qcfg=jq)
    tp = bridge.from_repro(jax.device_get(jp), device="cpu")
    x = rng.normal(size=(5, 48)).astype(np.float32).astype(npd)
    g = rng.normal(size=(5, 24)).astype(np.float32).astype(npd)
    jy, vjp = jax.vjp(lambda p, a: jcommon.dense_apply(
        p, a, qcfg=jq, quant_mode="qat", compute_dtype=jd), jp,
        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    tx = bridge.from_repro(x, device="cpu").requires_grad_(True)
    ty = tcommon.dense_apply(leaves, tx, qcfg=tq, quant_mode="qat",
                             compute_dtype=td)
    names = sorted(leaves)
    grads = torch.autograd.grad(ty, [leaves[k] for k in names] + [tx],
                                bridge.from_repro(g, device="cpu"))
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (2.0 ** -7, 1e-2)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=rtol, atol=atol)
    for k, gk in zip(names, grads):
        assert gk.dtype == leaves[k].dtype, k
        np.testing.assert_allclose(_np(gk), _np(jgp[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(_np(grads[-1]), _np(jgx), rtol=rtol,
                               atol=atol)
