"""``repro_torch.models.moe`` against ``repro.models.moe`` at reduced
mixtral size (d 64, d_ff 128, 4 experts, top-2, groups of 16), from the
reference's own init carried across the bridge.

Tolerances: f32 rtol 1e-5 (the same ops in another summation order); bf16
rtol 2^-7 (one bf16 ulp).  Both packages accumulate every product in f32
and round once: the expert GEMMs (XLA's bf16 dot and PyTorch's bf16
matmul on the CPU), and the combine, which the port writes as an f32 sum
of each token's (at most k) exact products, rounded once to the compute
dtype.  Router inputs are drawn from a normal, so no two probabilities
tie (``torch.topk`` and ``lax.top_k`` order ties differently).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -7)}
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


def _cfgs(dtype, **kw):
    kw.update(param_dtype=dtype, compute_dtype=dtype)
    return (jconfigs.get_config("mixtral-8x7b", reduced=True).replace(**kw),
            tconfigs.get_config("mixtral-8x7b", reduced=True).replace(**kw))


def _params(jcfg, seed):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.from_repro(jax.device_get(jp), device="cpu")


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_probs(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 0)
    jx, tx = _x(0, (48, jcfg.d_model), dtype)
    jprob, jidx, jaux = jmoe.router_probs(jp, jcfg, jx)
    tprob, tidx, taux = tmoe.router_probs(tp, tcfg, tx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _drops(jp, jcfg, x2d):
    """(token, choice) pairs the einsum path drops, recounted in numpy from
    the reference's routing."""
    _, idx, _ = jmoe.router_probs(jp, jcfg, x2d)
    idx = np.asarray(idx)
    t, k = idx.shape
    g = max(1, min(jcfg.moe_group_size, t))
    while t % g:
        g -= 1
    cap = max(int(np.ceil(g * k * jcfg.capacity_factor / jcfg.num_experts)),
              k)
    dropped = 0
    for grp in idx.reshape(t // g, g * k):
        counts = np.bincount(grp, minlength=jcfg.num_experts)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant_mode", ["none", "packed"])
@pytest.mark.parametrize("shape,cf,seed", [((2, 16), 1.25, 18),
                                           ((4, 1), 1.25, 8),
                                           ((3, 10), 0.5, 13)])
def test_moe_apply_einsum(dtype, quant_mode, shape, cf, seed):
    """Group blocking (30 tokens: groups of 15), capacities 10, 3 and 4,
    with capacity drops in every case: 4 decode tokens over 4 experts at
    cap 3 (seed 8 routes them to two experts; mixtral's 8 experts have cap
    2 at a decode batch of 4, so the serving path drops too)."""
    jcfg, tcfg = _cfgs(dtype, capacity_factor=cf)
    jp, tp = _params(jcfg, 1)
    jx, tx = _x(seed, (*shape, jcfg.d_model), dtype)
    assert _drops(jp, jcfg, jx.reshape(-1, jcfg.d_model)) > 0
    with jax.disable_jit():
        jy, jaux = jmoe.moe_apply_einsum(jp, jcfg, jx, quant_mode=quant_mode)
    ty, taux = tmoe.moe_apply_einsum(tp, tcfg, tx, quant_mode=quant_mode)
    assert ty.dtype == tx.dtype
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant_mode", ["none", "qat", "packed"])
def test_moe_apply_ragged(dtype, quant_mode):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 2)
    jx, tx = _x(2, (2, 12, jcfg.d_model), dtype)
    with jax.disable_jit():
        jy, jaux = jmoe.moe_apply(jp, jcfg, jx, quant_mode=quant_mode,
                                  path="ragged")
    ty, taux = tmoe.moe_apply(tp, tcfg, tx, quant_mode=quant_mode,
                              path="ragged")
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant_mode", ["none", "qat", "packed"])
@pytest.mark.parametrize("name", ["up", "gate", "down"])
def test_expert_kernel(dtype, quant_mode, name):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 3)
    want = jmoe._expert_kernel(jp, name, jcfg, quant_mode)
    got = tmoe._expert_kernel(tp, name, tcfg, quant_mode)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    jx, tx = _x(3, (5, jcfg.d_model), dtype)
    _close(tmoe._maybe_fq_act(tx, tp, name, tcfg, quant_mode),
           jmoe._maybe_fq_act(jx, jp, name, jcfg, quant_mode), dtype)


def test_init_matches_the_reference_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(0), jcfg,
                                      dtype=jnp.bfloat16))
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                       dtype=torch.bfloat16)
    flat_j = {tuple(str(k) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert len(flat_j) == 10
    for path, leaf in flat_j.items():
        node = tp
        for key in path:
            node = node[key.strip("[]'")]
        assert tuple(node.shape) == np.shape(leaf), path
        assert str(node.dtype).split(".")[-1] == np.asarray(leaf).dtype.name
    assert tp["router"]["kernel"].dtype == torch.float32
    want = float(jnp.mean(jnp.abs(jnp.asarray(tp["up"]["kernel"].float())))
                 * 2 / np.sqrt(3))
    np.testing.assert_allclose(float(tp["up"]["w_step"]), want, rtol=1e-5)


def test_one_hot_drops_out_of_range():
    got = tmoe._one_hot(torch.tensor([[0, -1], [2, 3]]), 3, torch.float32)
    want = jax.nn.one_hot(jnp.asarray([[0, -1], [2, 3]]), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant_mode", ["none", "qat", "packed"])
@pytest.mark.parametrize("name", ["up", "gate", "down"])
def test_per_expert_fake_quant_is_bit_identical(dtype, quant_mode, name):
    """Expert e's kernel fake-quantized alone equals row e of the
    whole-tensor pass bit for bit (the step is a scalar, the lattice
    elementwise)."""
    jcfg, tcfg = _cfgs(dtype)
    _, tp = _params(jcfg, 4)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    whole = tmoe._expert_kernel(tp, name, tcfg, quant_mode)
    for e in range(tcfg.num_experts):
        one = tmoe._expert_kernel(tp, name, tcfg, quant_mode, e)
        assert one.dtype == whole.dtype
        assert torch.equal(one.view(bits), whole[e].view(bits))


@pytest.mark.parametrize("path", ["einsum", "ragged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_experts_one_at_a_time_outside_autograd(dtype, path):
    """Under ``no_grad`` both paths take the experts one at a time; with
    the kernels recording gradients, the whole tensor (LSQ's step
    gradient is scaled by its size).  The outputs agree, and both match
    the reference."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, 5)
    jx, tx = _x(5, (2, 12, jcfg.d_model), dtype)
    with torch.no_grad():
        assert not tmoe._whole(tp)
        ty, _ = tmoe.moe_apply(tp, tcfg, tx, quant_mode="packed", path=path)
    grad = {k: ({n: t.clone().requires_grad_(t.is_floating_point())
                 for n, t in v.items()} if k in ("up", "gate", "down")
                else v) for k, v in tp.items()}
    assert tmoe._whole(grad)
    gy, _ = tmoe.moe_apply(grad, tcfg, tx, quant_mode="packed", path=path)
    _close(gy.detach(), ty.float().numpy(), dtype)
    with jax.disable_jit():
        jy, _ = jmoe.moe_apply(jp, jcfg, jx, quant_mode="packed", path=path)
    _close(ty, jy, dtype)
