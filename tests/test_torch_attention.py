"""K3 (flash-decoding attention over the stored KV cache) and the cache
write path against the JAX reference.

The port's plain version matches the reference Pallas kernel (interpret
mode, one query token) and its 'xla' backend (16-token windows) at every
kv_bits, with ragged live lengths and a dead row that must be exact zeros.
Tolerance: 2e-5 absolute / relative -- both sides compute in f32 from the
same stored bytes, so only summation order differs.  Ragged writes leave
byte-equal words and bf16 scale planes, including a write past max_len
that both must drop.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import ulppack_attention as jatt  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_attention as tatt  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402

torch.set_num_threads(2)

B, S, H, KVH, HD = 3, 24, 4, 2, 16
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def _cache(rng, kv_bits):
    """One stored cache, built by the reference writer, in both packages."""
    k = jnp.asarray(rng.standard_normal((B, S, KVH, HD)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, S, KVH, HD)), jnp.float32)
    if kv_bits in (8, 4, 2):
        qk, sk = jattention._kv_quantize(k, kv_bits)
        qv, sv = jattention._kv_quantize(v, kv_bits)
        jc = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        dt = jnp.bfloat16 if kv_bits == 16 else jnp.float32
        jc = {"k": k.astype(dt), "v": v.astype(dt)}
    tc = {}
    for name, arr in jc.items():
        a = np.array(arr)
        if a.dtype.name == "bfloat16":
            tc[name] = torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16)
        else:
            tc[name] = torch.from_numpy(a)
    return jc, tc


def _inputs(rng, c):
    q = rng.standard_normal((B, c, H, HD)).astype(np.float32)
    valid_len = np.array([S - 3, 7, 0], np.int32)      # row 2 is dead
    qpos = (np.maximum(valid_len, c)[:, None] - c
            + np.arange(c)[None, :]).astype(np.int32)
    return q, valid_len, qpos


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_plain_matches_pallas_decode(kv_bits):
    rng = np.random.default_rng(kv_bits)
    jc, tc = _cache(rng, kv_bits)
    q, vl, qp = _inputs(rng, 1)
    plan = jplan.plan_attention_decode(B, S, H, KVH, HD, kv_bits,
                                       backend="pallas",
                                       use_tuning_cache=False)
    plan = jplan.KernelPlan(**{**plan.__dict__, "block_k": 8,
                               "interpret": True})
    want = np.asarray(jatt._attention_decode_pallas(
        plan, jnp.asarray(q), jc, jnp.asarray(vl), jnp.asarray(qp),
        kv_bits=kv_bits, hd=HD))
    tplan_ = tplan.plan_attention_decode(B, 1, S, H, KVH, HD, kv_bits,
                                         device="cpu")
    got = tatt.fused_decode_attention(
        torch.from_numpy(q), tc, torch.from_numpy(vl), torch.from_numpy(qp),
        kv_bits=kv_bits, hd=HD, plan=tplan_)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()                              # dead row: zeros


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_plain_matches_xla_window(kv_bits):
    rng = np.random.default_rng(10 + kv_bits)
    jc, tc = _cache(rng, kv_bits)
    q, vl, qp = _inputs(rng, 16)
    plan = jplan.plan_attention_decode(B, S, H, KVH, HD, kv_bits,
                                       backend="xla", use_tuning_cache=False)
    want = np.asarray(jatt._attention_decode_xla(
        plan, jnp.asarray(q), jc, jnp.asarray(vl), jnp.asarray(qp),
        kv_bits=kv_bits, hd=HD))
    got = tatt.attention_decode_torch(
        torch.from_numpy(q), tc, torch.from_numpy(vl), torch.from_numpy(qp),
        kv_bits=kv_bits, hd=HD, block_k=5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()
    assert got.dtype == torch.float32


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
def test_ragged_writes_byte_equal(kv_bits):
    """Same ragged window writes -> byte-equal cache words and scales.  Row
    1 writes past max_len (slots S-2 .. S+5): the tail must be dropped."""
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro_torch import configs as tconfigs
    from repro_torch.core.quant import QuantConfig as TQ

    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        num_kv_heads=KVH, num_heads=H, quant=JQ(kv_bits=kv_bits))
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        num_kv_heads=KVH, num_heads=H, quant=TQ(kv_bits=kv_bits))
    jc = jattention.init_kv_cache(jcfg, B, S)
    tc = tattention.init_kv_cache(tcfg, B, S)
    rng = np.random.default_rng(kv_bits)
    sq = 8
    hd = jcfg.resolved_head_dim
    for idx, vlen in (([0, 0, 5], [8, 3, 0]), ([8, S - 2, 0], [4, 8, 1])):
        k = rng.standard_normal((B, sq, KVH, hd)).astype(np.float32)
        v = rng.standard_normal((B, sq, KVH, hd)).astype(np.float32)
        idx = np.asarray(idx, np.int32)
        vlen = np.asarray(vlen, np.int32)
        offs = np.arange(sq, dtype=np.int32)
        jc = jattention._cache_write_ragged(
            jc, jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(idx[:, None] + offs[None, :]),
            jnp.asarray(offs[None, :] < vlen[:, None]), kv_bits)
        dest = tattention.ragged_dest_rows(
            torch.from_numpy(idx), torch.from_numpy(vlen), sq, S)
        tattention.cache_write(tc, torch.from_numpy(k), torch.from_numpy(v),
                               dest, kv_bits)
    for name in jc:
        want = np.array(jc[name])
        got = tc[name]
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        assert got.numpy().tobytes() == want.tobytes(), name
    assert tc["k"][1, S - 2:].any() and not tc["k"][2, 1:].any()
