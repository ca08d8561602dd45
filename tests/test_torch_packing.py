"""repro_torch core algebra against the JAX reference: PackSpec geometry,
pack / unpack / word packing / extraction bit-equality, and quantize_affine
(including exact .5 ties, which both round half to even)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402

torch.set_num_threads(2)


def _specs(w, a):
    for lane, n, s in jpack.LAYOUT_FAMILY:
        yield (jpack.PackSpec(w, a, jnp.dtype(lane), n, s),
               tpack.PackSpec(w, a, lane, n, s))


def test_layout_geometry_matches_reference():
    """k_tile, feasibility, str/parse and the feasible family agree for
    every (w, a) in 1..8 and every member of LAYOUT_FAMILY."""
    assert tpack.LAYOUT_FAMILY == jpack.LAYOUT_FAMILY
    for w in range(1, 9):
        for a in range(1, 9):
            for js, ts in _specs(w, a):
                assert ts.k_tile == js.k_tile
                assert ts.feasible == js.feasible
                assert str(ts) == str(js)
                assert tpack.PackSpec.parse(str(js)) == ts
            assert [str(s) for s in tpack.layout_family(w, a)] == \
                [str(s) for s in jpack.layout_family(w, a)]
    assert tpack.PackSpec(2, 2).k_tile == 14


def _lattice(rng, shape, bits):
    return rng.integers(0, 1 << bits, shape).astype(np.int32)


@pytest.mark.parametrize("w,a", [(2, 2), (4, 4), (1, 3)])
def test_pack_unpack_bit_equal(w, a):
    rng = np.random.default_rng(w * 10 + a)
    for js, ts in _specs(w, a):
        if not js.feasible:
            continue
        qa = _lattice(rng, (3, 9), a)      # odd K: a padded tail lane
        qw = _lattice(rng, (9, 5), w)
        ja = np.asarray(jpack.pack_activations(jnp.asarray(qa), js))
        ta = tpack.pack_activations(torch.from_numpy(qa), ts)
        np.testing.assert_array_equal(ta.numpy(), ja)
        assert str(ta.dtype).endswith(ja.dtype.name)
        jw = np.asarray(jpack.pack_weights(jnp.asarray(qw), js))
        tw = tpack.pack_weights(torch.from_numpy(qw), ts)
        np.testing.assert_array_equal(tw.numpy(), jw)
        for rev, packed in ((False, ta), (True, tw.T.contiguous())):
            np.testing.assert_array_equal(
                tpack.unpack(packed, ts, reversed_fields=rev).numpy(),
                np.asarray(jpack.unpack(jnp.asarray(packed.numpy()), js,
                                        reversed_fields=rev)))
        got = tpack.packed_matmul_reference(torch.from_numpy(qa),
                                            torch.from_numpy(qw), ts)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpack.packed_matmul_reference(
                jnp.asarray(qa), jnp.asarray(qw), js)))
        np.testing.assert_array_equal(got.numpy(), qa @ qw)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_pack_words_and_extract_bit_equal(bits):
    rng = np.random.default_rng(bits)
    q = _lattice(rng, (2, 3, 19), bits)
    jw = np.asarray(jpack.pack_words(jnp.asarray(q), bits, axis=-1))
    tw = tpack.pack_words(torch.from_numpy(q), bits, axis=-1)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(
        tpack.unpack_words(tw, bits, 19).numpy(), q)
    np.testing.assert_array_equal(
        tpack.unpack_words(tw, bits, 19).numpy(),
        np.asarray(jpack.unpack_words(jnp.asarray(jw), bits, 19)))
    # the bit-dense weight store packs the K axis the same way
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    qk = q.reshape(-1, 19).T.copy()                     # [K=19, N=6]
    np.testing.assert_array_equal(
        tops.dense_store_weights(torch.from_numpy(qk), bits).numpy(),
        np.asarray(jops.dense_store_weights(jnp.asarray(qk), bits)))
    np.testing.assert_array_equal(tops.dense_load_weights(
        tops.dense_store_weights(torch.from_numpy(qk), bits), bits,
        19).numpy(), qk)
    # extraction from wrapped s32 totals, including negative values
    acc = rng.integers(-2**31, 2**31, (64,), dtype=np.int64).astype(np.int32)
    for js, ts in _specs(2, 2):
        np.testing.assert_array_equal(
            tpack.extract_dot(torch.from_numpy(acc), ts).numpy(),
            np.asarray(jpack.extract_dot(jnp.asarray(acc), js)))


def test_quantize_affine_bit_equal_with_ties():
    rng = np.random.default_rng(3)
    scale = np.float32(0.25)
    x = rng.standard_normal(4096).astype(np.float32)
    # exact .5 ties on the lattice: x / scale = k + 0.5
    ties = ((np.arange(-8, 8) + 0.5) * scale).astype(np.float32)
    x = np.concatenate([x, ties, -ties])
    for bits, zp in ((2, 2), (4, 8), (8, 128)):
        want = np.asarray(jquant.quantize_affine(
            jnp.asarray(x), jnp.float32(scale), jnp.int32(zp), bits))
        got = tquant.quantize_affine(
            torch.from_numpy(x), torch.tensor(scale),
            torch.tensor(zp, dtype=torch.int32), bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tquant.dequantize_affine(got, torch.tensor(scale), zp).numpy(),
            np.asarray(jquant.dequantize_affine(jnp.asarray(want),
                                                jnp.float32(scale), zp)))
    # ties really round half to even (0.5 -> 0, 1.5 -> 2)
    got = tquant.quantize_affine(torch.tensor([0.5, 1.5, 2.5]),
                                 torch.tensor(1.0), 0, 4)
    assert got.tolist() == [0, 2, 2]


def test_overflow_free_region_matches_reference():
    """The k_tile table of every lane dtype and field count equals the
    reference's (paper Fig. 5's region)."""
    for lane in ("int8", "int16", "int32"):
        for n_pack in (2, 4):
            want = jpack.overflow_free_region(jnp.dtype(lane), n_pack, 8)
            got = tpack.overflow_free_region(tpack.lane_dtype_of(lane),
                                             n_pack, 8)
            assert got == want, (lane, n_pack)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("fill", ["random", "min", "max", "mixed"])
def test_tile_dots_f64_exact(dtype, fill):
    """The card's contraction of 8- and 16-bit lanes (a float64 bmm) is the
    int32 bmm's wrapped result bit for bit, at random lanes and at the
    lane extremes where the sums pass 2^31, in small chunks of tiles."""
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(3)
    t, m, kt, n = 5, 3, 127, 7
    a = torch.randint(info.min, info.max + 1, (t, m, kt), generator=g,
                      dtype=torch.int64).to(dtype)
    w = torch.randint(info.min, info.max + 1, (t, kt, n), generator=g,
                      dtype=torch.int64).to(dtype)
    if fill == "min":
        a.fill_(info.min), w.fill_(info.min)
    elif fill == "max":
        a.fill_(info.max), w.fill_(info.max)
    elif fill == "mixed":
        a.fill_(info.min), w.fill_(info.max)
    want = torch.bmm(a.to(torch.int32), w.to(torch.int32))
    for budget in (1 << 28, m * n * 8):
        got = tpack.tile_dots_f64(a, w, budget)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    # the wide route (int64 products), run here on the CPU, agrees
    wide = tpack.wrap_i32((a.to(torch.int64)[..., None]
                           * w.to(torch.int64)[:, None]).sum(dim=2))
    assert torch.equal(wide, want)


def test_tile_dots_f64_refuses_what_it_cannot_hold():
    a = torch.zeros((1, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 / int16"):
        tpack.tile_dots_f64(a, torch.zeros((1, 3, 2), dtype=torch.int32))
