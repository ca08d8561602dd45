"""K4 (flash-decoding attention over a paged KV pool) and the paged cache
write against the JAX reference.

The port's paged plain version matches the reference Pallas kernel's paged
branch (interpret mode, one query token) and its 'xla' backend with
``block_tables`` (16-token windows) at every kv_bits, through a scrambled
block table (a random permutation of the physical pages), with ragged live
lengths, a dead row that must be exact zeros, and table entries past the
live length that point outside the pool.  Tolerance: 2e-5 absolute /
relative, as for K3 -- both sides compute in f32 from the same stored
bytes, so only summation order differs.  Paged writes leave byte-equal
words and bf16 scale planes; pools and page bytes match the reference's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import ulppack_attention as jatt  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import ulppack_attention as tatt  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)

B, PS, NP, H, KVH, HD = 3, 8, 4, 4, 2, 16
P = B * NP + 2                       # two pages no table points at
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


def _to_torch(arr):
    a = np.array(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pool(rng, kv_bits):
    """One stored pool [P, PS, KVH, ...], written by the reference's
    quantizer, in both packages."""
    k = jnp.asarray(rng.standard_normal((P, PS, KVH, HD)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((P, PS, KVH, HD)), jnp.float32)
    if kv_bits in (8, 4, 2):
        qk, sk = jattention._kv_quantize(k, kv_bits)
        qv, sv = jattention._kv_quantize(v, kv_bits)
        jc = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        dt = jnp.bfloat16 if kv_bits == 16 else jnp.float32
        jc = {"k": k.astype(dt), "v": v.astype(dt)}
    return jc, {name: _to_torch(a) for name, a in jc.items()}


def _inputs(rng, c):
    """Queries, live lengths (row 2 dead), query positions and a scrambled
    table whose entries past row 1's live pages point outside the pool."""
    q = rng.standard_normal((B, c, H, HD)).astype(np.float32)
    valid_len = np.array([NP * PS - 3, 11, 0], np.int32)
    qpos = (np.maximum(valid_len, c)[:, None] - c
            + np.arange(c)[None, :]).astype(np.int32)
    bt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    bt[1, 2:] = [P + 5, -3]                  # rows 16.. of row 1: not live
    return q, valid_len, qpos, bt


def _plain(q, tc, vl, qp, bt, kv_bits, c, block_k=None):
    plan = tplan.plan_attention_decode(B, c, NP * PS, H, KVH, HD, kv_bits,
                                       page_size=PS, device="cpu")
    if block_k is not None:
        plan = tplan.KernelPlan(**{**plan.__dict__, "block_k": block_k})
    return tatt.fused_decode_attention(
        torch.from_numpy(q), tc, torch.from_numpy(vl), torch.from_numpy(qp),
        kv_bits=kv_bits, hd=HD, plan=plan,
        block_tables=torch.from_numpy(bt))


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_paged_plain_matches_pallas_decode(kv_bits):
    rng = np.random.default_rng(kv_bits)
    jc, tc = _pool(rng, kv_bits)
    q, vl, qp, bt = _inputs(rng, 1)
    plan = jplan.plan_attention_decode(B, NP * PS, H, KVH, HD, kv_bits,
                                       page_size=PS, backend="pallas",
                                       use_tuning_cache=False)
    plan = jplan.KernelPlan(**{**plan.__dict__, "interpret": True})
    want = np.asarray(jatt._attention_decode_pallas(
        plan, jnp.asarray(q), jc, jnp.asarray(vl), jnp.asarray(qp),
        kv_bits=kv_bits, hd=HD, block_tables=jnp.asarray(bt)))
    got = _plain(q, tc, vl, qp, bt, kv_bits, 1, block_k=PS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()                              # dead row: zeros


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_paged_plain_matches_xla_window(kv_bits):
    rng = np.random.default_rng(10 + kv_bits)
    jc, tc = _pool(rng, kv_bits)
    q, vl, qp, bt = _inputs(rng, 16)
    bt_in = np.clip(bt, 0, P - 1)     # the 'xla' gather wraps negative ids
    plan = jplan.plan_attention_decode(B, NP * PS, H, KVH, HD, kv_bits,
                                       page_size=PS, backend="xla",
                                       use_tuning_cache=False)
    want = np.asarray(jatt._attention_decode_xla(
        plan, jnp.asarray(q), jc, jnp.asarray(vl), jnp.asarray(qp),
        kv_bits=kv_bits, hd=HD, block_tables=jnp.asarray(bt_in)))
    got = _plain(q, tc, vl, qp, bt, kv_bits, 16, block_k=2 * PS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[2].any()
    assert got.dtype == torch.float32


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_paged_plain_equals_contiguous(kv_bits):
    """The same logical rows read through the table and laid out
    contiguously give the same result with the same group length."""
    rng = np.random.default_rng(20 + kv_bits)
    _, tc = _pool(rng, kv_bits)
    q, vl, qp, bt = _inputs(rng, 3)
    bt[1, 2:] = bt[0, :2]                    # in range: gather is real
    got = _plain(q, tc, vl, qp, bt, kv_bits, 3, block_k=PS)
    idx = torch.from_numpy(bt).long()
    flat = {n: t[idx].reshape(B, NP * PS, *t.shape[2:])
            for n, t in tc.items()}
    want = tatt.attention_decode_torch(
        torch.from_numpy(q), flat, torch.from_numpy(vl),
        torch.from_numpy(qp), kv_bits=kv_bits, hd=HD, block_k=PS)
    assert torch.equal(got, want)


def _cfgs(kv_bits):
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        num_kv_heads=KVH, num_heads=H, quant=JQ(kv_bits=kv_bits))
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        num_kv_heads=KVH, num_heads=H, quant=TQ(kv_bits=kv_bits))
    return jcfg, tcfg


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_paged_writes_byte_equal(kv_bits):
    """The same windows written through a block table -> byte-equal pool
    words and scale planes.  Invalid tokens (past each row's count, and a
    dead row) are dropped; row 1 crosses a page boundary."""
    jcfg, tcfg = _cfgs(kv_bits)
    jc = jattention.init_paged_kv_cache(jcfg, P, PS)
    tc = tattention.init_paged_kv_cache(tcfg, P, PS)
    rng = np.random.default_rng(kv_bits)
    bt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    sq = 8
    hd = jcfg.resolved_head_dim
    for idx, vlen in (([0, 0, 5], [8, 3, 0]), ([8, 5, 0], [4, 8, 1])):
        k = rng.standard_normal((B, sq, KVH, hd)).astype(np.float32)
        v = rng.standard_normal((B, sq, KVH, hd)).astype(np.float32)
        idx = np.asarray(idx, np.int32)
        vlen = np.asarray(vlen, np.int32)
        offs = np.arange(sq, dtype=np.int32)
        wpos = idx[:, None] + offs[None, :]
        pages = np.take_along_axis(bt, np.clip(wpos // PS, 0, NP - 1), 1)
        jc = jattention._cache_write_paged(
            jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
            jnp.asarray(wpos % PS), jnp.asarray(offs[None, :] < vlen[:, None]),
            kv_bits)
        dest = tattention.paged_dest_rows(
            torch.from_numpy(idx), torch.from_numpy(vlen),
            torch.from_numpy(bt), sq, PS, P)
        tattention.cache_write(tc, torch.from_numpy(k), torch.from_numpy(v),
                               dest, kv_bits)
    for name in jc:
        got = tc[name]
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        assert got.numpy().tobytes() == np.array(jc[name]).tobytes(), name
    assert tc["k"][bt[1, 1]].any()               # the boundary crossing
    unused = sorted(set(range(P)) - set(bt.reshape(-1).tolist()))
    assert not tc["k"][unused].any()


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
def test_init_paged_kv_cache_matches(kv_bits):
    jcfg, tcfg = _cfgs(kv_bits)
    want = jattention.init_paged_kv_cache(jcfg, P, PS)
    got = tattention.init_paged_kv_cache(tcfg, P, PS)
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape)
        assert str(got[name].dtype).split(".")[-1] == np.dtype(
            leaf.dtype).name
        assert not got[name].any()
    caches = tlm.init_caches(tcfg, 2, 64, page_size=PS, num_pages=P,
                             device="cpu")
    assert len(caches) == tcfg.num_layers
    assert tuple(caches[0]["attn"]["k"].shape) == tuple(want["k"].shape)


@pytest.mark.parametrize("kv_bits", [0, 16, 8, 4, 2])
@pytest.mark.parametrize("page_size", [16, 32])
def test_cache_page_bytes_match(kv_bits, page_size):
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(kv_bits=kv_bits))
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(kv_bits=kv_bits))
    assert tlm.cache_page_bytes(tcfg, page_size) \
        == jlm.cache_page_bytes(jcfg, page_size)
    assert tlm.cache_bytes(tcfg, 3, 40) == jlm.cache_bytes(jcfg, 3, 40)


def test_sliding_window_pool_rejected():
    _, tcfg = _cfgs(4)
    with pytest.raises(ValueError, match="sliding-window"):
        tattention.init_paged_kv_cache(tcfg.replace(sliding_window=8), P, PS)
