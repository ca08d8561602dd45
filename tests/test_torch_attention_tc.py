"""A CPU model of K3/K4's tile path (csrc/attention_decode.cu,
``attention_tile_kernel``): its operand split and its order of sums.

The kernel runs the products of a block of more than 4 query rows on the
bf16 tensor cores: q goes in as the bf16 terms that hold it exactly (hi
+ mid + lo, each the bf16 rounding of what the terms before it leave:
one for bf16 q, two for f16, three for f32) with hd^-0.5 scaling the f32
dot, p x sv (f32) as three terms, K and V as their exact bf16 values
(sub-byte fields, int8, bf16) or, for the f32 cache, three terms too (six
of the nine term pairs).  Each product of two bf16 terms is exact in f32
and the sums are f32.  Keys go 16 at a step through each warp's slice of
a staged tile, with an online softmax in f32; the key slices merge in
order at the split's end, the splits in order at the end.

:func:`tile_emulation` runs that scheme in torch on the CPU -- each term
rounded to bf16, the products taken in f32 and summed in f32, in the
kernel's key-slice and merge order -- at the planner's geometry.  It is
held within ATTN_TOL of the plain version and of the reference's
``_attention_decode_xla`` for every cache kind, at small tile-path
shapes, before any card run.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import ulppack_attention as jatt  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.kernels import ulppack_attention as att  # noqa: E402

torch.set_num_threads(2)

#: The card gates: within 1e-4 (absolute and relative) with f32 queries.
ATTN_TOL = 1e-4
NEG_INF = -1e30
KV_BITS = [0, 16, 8, 4, 2]

# (B, S, H, KVH, hd, C, non-causal): a verify window (C5), a prefill chunk
# (C16 on a GQA-2 layout at hd 128), a GQA group of 6 (C2: 12 rows), and
# C 64 with every key admitted (the encoder's read); the first three with
# ragged live lengths and a dead row.
SHAPES = {"c5": (3, 96, 4, 4, 64, 5, False),
          "c16_hd128": (3, 96, 4, 2, 128, 16, False),
          "g6": (3, 96, 12, 2, 128, 2, False),
          "c64_noncausal": (2, 64, 2, 2, 64, 64, True)}


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def split3(x):
    """The kernel's three bf16 terms of an f32 tensor (x = h + m + l)."""
    h = bf16(x)
    m = bf16(x - h)
    return h, m, x - h - m


def term_products(xs, ys, pair):
    """sum over the kernel's term pairs (a + b <= 2; the smaller terms
    first) of pair(x_a, y_b), each product of two bf16 terms exact in f32
    and the sum in f32."""
    out = None
    for a in reversed(range(len(xs))):
        for b in reversed(range(len(ys))):
            if a + b <= 2:
                p = pair(xs[a], ys[b])
                out = p if out is None else out + p
    return out


def _cache_values(cache, kv_bits, hd):
    """K and V as their bf16 terms ([B, S, KVH, hd] f32 tensors: one exact
    term, or three of the f32 cache), and the scales (or None)."""
    def terms(t):
        if kv_bits in (4, 2):
            return [att._unpack_group(t, kv_bits, hd)]
        if t.dtype == torch.float32:
            return list(split3(t))
        return [t.to(torch.float32)]
    sc = ((cache["k_scale"].float(), cache["v_scale"].float())
          if "k_scale" in cache else (None, None))
    return terms(cache["k"]), terms(cache["v"]), sc


def tile_emulation(q, cache, valid_len, qpos, *, kv_bits, hd, plan):
    """The tile path's arithmetic at ``plan``'s geometry, on the CPU."""
    b, c, h, _ = q.shape
    s, kvh = cache["k"].shape[1], cache["k"].shape[2]
    g = h // kvh
    zp = (1 << (kv_bits - 1)) if kv_bits in (4, 2) else 0
    kt, vt, (sk, sv) = _cache_values(cache, kv_bits, hd)
    # query rows of a kv head: r = c_i * G + head, as the kernel orders them
    qscale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    qr = q.float().reshape(b, c, kvh, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, kvh, c * g, hd)
    qsum = (qr * qscale).sum(-1)
    xq = split3(qr)
    qp = qpos[:, None, :, None].expand(b, kvh, c, g).reshape(b, kvh, c * g)
    rows = c * g
    tile, split_rows = plan.tile_rows, plan.split_rows
    wk = plan_lib.attention_tile_warps(plan.block_m, tile, hd)[1]
    ks_rows = tile // wk

    def carry():
        return (torch.full((b, kvh, rows), NEG_INF),
                torch.zeros((b, kvh, rows)), torch.zeros((b, kvh, rows)),
                torch.zeros((b, kvh, rows, hd)))

    def merge(carries):
        mx = torch.stack([m for m, *_ in carries]).amax(0)
        l_t, acc = torch.zeros_like(mx), torch.zeros_like(carries[0][3])
        for m, l_, _, a in carries:
            f = torch.exp(m - mx)
            l_t = l_t + l_ * f
            acc = acc + a * f[..., None]
        return mx, l_t, acc

    splits = []
    for s0 in range(0, plan.splits * split_rows, split_rows):
        slices = []
        for ks in range(wk):
            m, l_, z, acc = carry()
            for t0 in range(s0, s0 + split_rows, tile):
                for k0 in range(t0 + ks * ks_rows,
                                t0 + (ks + 1) * ks_rows, 16):
                    keys = torch.arange(k0, k0 + 16)
                    live = keys < s
                    kk = keys.clamp(max=s - 1)
                    ktile = [t[:, kk].permute(0, 2, 1, 3) for t in kt]
                    sc = qscale * term_products(xq, ktile, lambda u, w:
                                                u @ w.transpose(-1, -2))
                    if sk is not None:
                        skt = sk[:, kk].permute(0, 2, 1)[:, :, None, :]
                        sc = skt * (sc - zp * qsum[..., None]) if zp \
                            else skt * sc
                    vis = (live[None, None, None, :]
                           & (keys[None, None, None, :]
                              < valid_len[:, None, None, None])
                           & (keys[None, None, None, :] <= qp[..., None]))
                    mx = torch.where(vis, sc, NEG_INF).amax(-1)
                    mn = torch.maximum(m, mx)
                    corr = torch.exp(m - mn)
                    p = torch.where(vis, torch.exp(sc - mn[..., None]), 0.0)
                    pv = p if sv is None else \
                        p * sv[:, kk].permute(0, 2, 1)[:, :, None, :]
                    l_ = l_ * corr + p.sum(-1)
                    z = z * corr + pv.sum(-1)
                    vtile = [torch.where(live[None, None, :, None],
                                         t[:, kk].permute(0, 2, 1, 3), 0.0)
                             for t in vt]
                    acc = acc * corr[..., None] + term_products(
                        split3(pv), vtile, lambda u, w: u @ w)
                    m = mn
            if zp:
                acc = acc - zp * z[..., None]
            slices.append((m, l_, None, acc))
        splits.append(merge(slices))
    _, l_t, acc = merge([(m, l_, None, a) for m, l_, a in splits])
    out = torch.where(l_t[..., None] == 0, 0.0,
                      acc / torch.where(l_t == 0, 1.0, l_t)[..., None])
    return out.reshape(b, kvh, c, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, h, hd)


def _case(kv_bits, shape, seed):
    """The cache in both packages (built by the reference's writer), f32
    q, the live lengths and query positions."""
    b, s, h, kvh, hd, c, noncausal = SHAPES[shape]
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), jnp.float32)
    if kv_bits in (8, 4, 2):
        (qk, sk), (qv, sv) = (jattention._kv_quantize(t, kv_bits)
                              for t in (k, v))
        jc = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        dt = jnp.bfloat16 if kv_bits == 16 else jnp.float32
        jc = {"k": k.astype(dt), "v": v.astype(dt)}
    tc = {}
    for name, arr in jc.items():
        a = np.array(arr)
        tc[name] = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                    if a.dtype.name == "bfloat16" else torch.from_numpy(a))
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    if noncausal:
        vl = np.full((b,), s, np.int32)
        qp = np.full((b, c), s - 1, np.int32)
    else:
        vl = np.array([s - 3, 37, 0], np.int32)[:b]       # row 2 is dead
        qp = (np.maximum(vl, c)[:, None] - c
              + np.arange(c)[None, :]).astype(np.int32)
    return jc, tc, q, vl, qp, hd


def _emulate(tc, q, vl, qp, kv_bits, hd):
    b, c, h, _ = q.shape
    s, kvh = tc["k"].shape[1], tc["k"].shape[2]
    plan = plan_lib.plan_attention_decode(b, c, s, h, kvh, hd, kv_bits,
                                          cache_dtype=tc["k"].dtype,
                                          device="cpu")
    assert not plan_lib.attention_warp_path(plan.block_m, hd)
    got = tile_emulation(torch.from_numpy(q), tc, torch.from_numpy(vl),
                         torch.from_numpy(qp), kv_bits=kv_bits, hd=hd,
                         plan=plan)
    return got, plan


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_tile_emulation_matches_plain(kv_bits, shape):
    """The bf16-term scheme in the kernel's order is within ATTN_TOL of
    the port's plain version (f32 throughout); dead rows are zero."""
    _, tc, q, vl, qp, hd = _case(kv_bits, shape, 3 + kv_bits)
    got, plan = _emulate(tc, q, vl, qp, kv_bits, hd)
    want = att.attention_decode_torch(
        torch.from_numpy(q), tc, torch.from_numpy(vl), torch.from_numpy(qp),
        kv_bits=kv_bits, hd=hd, block_k=plan.block_k)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    for i in np.flatnonzero(vl == 0):
        assert not got[i].any()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_tile_emulation_matches_reference(kv_bits, shape):
    """... and of the reference's fused read (``_attention_decode_xla``,
    which also takes windows wider than one token)."""
    jc, tc, q, vl, qp, hd = _case(kv_bits, shape, 3 + kv_bits)
    b, c, h, _ = q.shape
    s, kvh = tc["k"].shape[1], tc["k"].shape[2]
    got, _ = _emulate(tc, q, vl, qp, kv_bits, hd)
    jp = jplan.plan_attention_decode(b, s, h, kvh, hd, kv_bits,
                                     backend="xla", use_tuning_cache=False)
    want = np.asarray(jatt._attention_decode_xla(
        jp, jnp.asarray(q), jc, jnp.asarray(vl), jnp.asarray(qp),
        kv_bits=kv_bits, hd=hd))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_three_terms_hold_an_f32_exactly(hd):
    """hi + mid + lo gives back every f32 (the scaled q and p x sv), each
    term a bf16; the product of a term with an exact bf16 operand (a
    sub-byte field, an int8, a bf16 value) is exact in f32."""
    g = torch.Generator().manual_seed(hd)
    x = torch.randn((64, hd), generator=g) * hd ** -0.5
    x = torch.cat([x, torch.rand((8, hd), generator=g) * 1e-3,
                   torch.tensor([[1.0 / 3, -2.0 / 7, 1e-30, 0.0]]).expand(
                       1, 4).repeat(1, hd // 4)])
    h, m, lo = split3(x)
    for t in (h, m, lo):
        assert torch.equal(t, bf16(t))
    assert torch.equal(h + m + lo, x)
    w = torch.randint(-128, 128, (hd,)).float()
    for t in (h, m, lo):
        prod = t * w
        assert torch.equal(prod.double(), t.double() * w.double())


@pytest.mark.parametrize("dtype,terms", [(torch.bfloat16, 1),
                                         (torch.float16, 2),
                                         (torch.float32, 3)])
def test_q_terms_follow_its_dtype(dtype, terms):
    """q goes in unscaled, so its terms follow its dtype: bf16 q is its
    own one term, f16 (11 bits) takes two, f32 three; the kernel loads
    that many planes (hd^-0.5 scales the f32 dot)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((16, 128), generator=g).to(dtype).float()
    _, m, lo = split3(x)
    got = 3 if lo.any() else 2 if m.any() else 1
    assert got == terms
