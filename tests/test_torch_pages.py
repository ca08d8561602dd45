"""The port's page pool (``repro_torch.serve.pages``) against the JAX
reference's (``repro.serve.pages``): the same operation sequences through
both give the same page ids, the same ``report()`` and the same
``export_meta()`` at every step.  The sequences mirror
``tests/test_paged_kv.py``'s pool tests.  ``copy_page`` copies every
attention leaf in place, byte-equal to the reference's functional copy."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.serve import pages as jpages  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.serve import pages as tpages  # noqa: E402


def _plain(x):
    """Observations as plain Python values (numpy ints and arrays too)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _attempt(fn, *args, **kwargs):
    """A call's result, or the type and message of what it raised."""
    try:
        return fn(*args, **kwargs)
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _state(pool):
    return {"report": pool.report(), "meta": pool.export_meta(),
            "ref": pool.ref.copy()}


def seq_alloc_refcounts(pages):
    pool = pages.PagePool(num_pages=4, page_size=4)
    log = []
    got = pool.alloc(3)
    log += [got, _state(pool)]
    log += [pool.alloc(2), _state(pool)]          # all-or-nothing: None
    p = got[0]
    pool.retain(p)
    log += [pool.is_shared(p), pool.is_immutable(p), _state(pool)]
    pool.release(p)
    pool.release(p)                               # ref 0: back on free list
    log += [_state(pool), _attempt(pool.release, p)]
    log += [pool.alloc(3), _state(pool)]
    return log


def seq_register_match(pages):
    pool = pages.PagePool(num_pages=8, page_size=4)
    toks = list(range(100, 110))                  # 2 full pages + tail 2
    held = pool.alloc(3)
    log = [held, pool.register_prefix(toks, held), _state(pool)]
    log.append([pool.is_immutable(p) for p in held])
    log.append(pool.match_prefix(toks))
    log.append(pool.match_prefix(toks[:5] + [999] * 5))   # mid-page split
    log.append(pool.match_prefix(toks, max_tokens=3))
    log.append(pool.match_prefix([7, 7, 7]))
    dup = pool.alloc(3)
    log += [dup, pool.register_prefix(toks, dup), _state(pool)]
    pool.prefix_hits += 2
    pool.prefix_hit_tokens += 13
    log.append(_state(pool))
    return log


def seq_eviction(pages):
    pool = pages.PagePool(num_pages=2, page_size=2)
    (a, b) = pool.alloc(2)
    log = [pool.register_prefix([1, 2, 3, 4], [a, b])]
    pool.release(a)
    pool.release(b)                               # index-only now
    log.append(_state(pool))
    log += [pool.alloc(1), _state(pool)]          # the leaf goes first
    log.append(pool.match_prefix([1, 2, 3, 4]))
    log += [pool.alloc(1), _state(pool)]          # then the orphaned parent
    log.append(pool.match_prefix([1, 2]))
    pool2 = pages.PagePool(num_pages=2, page_size=2)
    (c, _d) = pool2.alloc(2)
    log.append(pool2.register_prefix([5, 6], [c]))
    log += [pool2.alloc(1), _state(pool2)]        # shared leaf: no victim
    return log


def seq_lru_touch(pages):
    pool = pages.PagePool(num_pages=3, page_size=2)
    (a,) = pool.alloc(1)
    log = [pool.register_prefix([1, 2], [a])]
    (b,) = pool.alloc(1)
    log.append(pool.register_prefix([3, 4], [b]))
    pool.release(a)
    pool.release(b)
    log.append(pool.match_prefix([1, 2]))         # a most recently used
    (c,) = pool.alloc(1)
    pool.release(c)
    log += [pool.alloc(2), _state(pool)]          # evicts b, not a
    log += [pool.match_prefix([1, 2]), pool.match_prefix([3, 4])]
    return log


def seq_meta_round_trip(pages):
    pool = pages.PagePool(num_pages=6, page_size=8, kv_bits=4)
    held = pool.alloc(3)
    toks = list(range(18))                        # 2 full pages + tail 2
    pool.register_prefix(toks, held)
    pool.release(held[2])
    pool.prefix_hits, pool.prefix_hit_tokens, pool.cow_copies = 2, 9, 1
    clone = pages.PagePool.from_meta(pool.export_meta())
    log = [_state(pool), _state(clone), clone.match_prefix(toks),
           clone.match_prefix(toks[:4])]
    log += [clone.alloc(4), _state(clone)]        # evicts through the clone
    return log


@pytest.mark.parametrize("seq", [seq_alloc_refcounts, seq_register_match,
                                 seq_eviction, seq_lru_touch,
                                 seq_meta_round_trip],
                         ids=lambda f: f.__name__[4:])
def test_pool_sequences_match_reference(seq):
    assert _plain(seq(tpages)) == _plain(seq(jpages))


@pytest.mark.parametrize("bits", [0, 8, 4, 2])
def test_page_granularity_matches(bits):
    assert tpages.page_granularity(bits) == jpages.page_granularity(bits)


@pytest.mark.parametrize("ps,bits", [(16, 0), (16, 8), (16, 4), (16, 2),
                                     (8, 4), (8, 2), (12, 4), (1, 0), (0, 4)])
def test_validate_page_size_matches(ps, bits):
    assert _attempt(tpages.validate_page_size, ps, bits) \
        == _attempt(jpages.validate_page_size, ps, bits)


@pytest.mark.parametrize("args", [(0, 4), (4, 4, 2), (4, 0)])
def test_pool_constructor_rejections_match(args):
    got = _attempt(tpages.PagePool, *args)
    assert isinstance(got, tuple) and got[0] == "ValueError"
    assert got == _attempt(jpages.PagePool, *args)


def _bytes(t):
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
def test_copy_page_in_place_byte_equal(kv_bits):
    """Pools filled with the same random bytes; the port's in-place copy of
    page 1 -> 3 equals the reference's functional copy in every attention
    leaf, and every leaf keeps its data_ptr()."""
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(kv_bits=kv_bits))
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(kv_bits=kv_bits))
    rng = np.random.default_rng(kv_bits)
    jcaches, tcaches = [], []
    for _ in range(2):
        jc, tc = {}, {}
        tpl = tattention.init_paged_kv_cache(tcfg, 5, 16)
        for name, leaf in jattention.init_paged_kv_cache(jcfg, 5, 16).items():
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":   # finite: XLA may rewrite NaNs
                arr = rng.standard_normal(arr.shape).astype(arr.dtype)
                tc[name] = torch.from_numpy(arr.view(np.int16).copy()) \
                    .view(torch.bfloat16)
            else:
                info = np.iinfo(arr.dtype)
                arr = rng.integers(info.min, info.max, arr.shape,
                                   dtype=arr.dtype, endpoint=True)
                tc[name] = torch.from_numpy(arr.copy())
            assert tc[name].dtype == tpl[name].dtype
            assert tc[name].shape == tpl[name].shape
            jc[name] = jnp.asarray(arr)
        jcaches.append({"attn": jc})
        tcaches.append({"attn": tc})
    ptrs = [t.data_ptr() for c in tcaches for t in c["attn"].values()]
    want = jpages.copy_page(jcaches, src=1, dst=3)
    got = tpages.copy_page(tcaches, src=1, dst=3)
    assert got is tcaches
    assert [t.data_ptr() for c in got for t in c["attn"].values()] == ptrs
    for w, g in zip(want, got):
        assert set(w["attn"]) == set(g["attn"])
        for name in w["attn"]:
            assert _bytes(g["attn"][name]) == np.asarray(
                w["attn"][name]).tobytes(), name
