"""The autotuner on the card (kernels/autotune.py): every candidate the
planner enumerates launches and agrees with the plain version, the tuners'
winners are adopted, and the engine, the CNN and the serving CLI run from
a tuned cache.  Marked ``cuda``: every test skips (inside the ``hopper``
fixture, never at import) unless a CUDA device of capability (9, 0) or
newer is present.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_cuda_autotune.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.kernels import ulppack_attention as ua  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention, cnn, lm  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402

pytestmark = pytest.mark.cuda

SP = PackSpec.parse("W2A2/int16xP2s8")


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Each test tunes into a fresh, empty active cache."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cuda"))
    yield
    autotune.set_active_cache(old)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _ints(gen, hi, shape, dev):
    return torch.randint(0, hi + 1, shape, generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("m,kp,n", [(4, 256, 384), (64, 1024, 256),
                                    (17, 100, 130)])
@pytest.mark.parametrize("spec", ["W2A2/int16xP2s8", "W2A2/int32xP2s16",
                                  "W1A1/int8xP2s4"])
@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_every_k2_candidate_bit_equal(hopper, m, kp, n, spec, store):
    sp = PackSpec.parse(spec)
    gen = torch.Generator(device=hopper).manual_seed(m + kp)
    k = kp * sp.n_pack
    qa, qw = _ints(gen, sp.max_a, (m, k), hopper), \
        _ints(gen, sp.max_w, (k, n), hopper)
    a = packing.pack_activations(qa, sp)
    w = ops.dense_store_weights(qw, sp.w_bits) if store == "dense" \
        else packing.pack_weights(qw, sp)
    want = ops.packed_matmul(a, w, sp, backend="torch", weight_store=store)
    heur = plan_lib.plan_packed_matmul(m, kp, n, sp, weight_store=store,
                                       device=hopper)
    cands = plan_lib.packed_matmul_candidates(m, kp, n, sp,
                                              weight_store=store,
                                              device=hopper)
    assert cands
    for geo in cands:
        plan = dataclasses.replace(heur, **geo)
        assert torch.equal(ops.packed_matmul(a, w, sp, plan=plan), want), geo


@pytest.mark.parametrize("m,k,n", [(4, 2048, 256), (64, 512, 384),
                                   (9, 200, 130)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("store", ["lanes", "dense"])
def test_every_fused_candidate_bit_equal(hopper, m, k, n, x_dtype, store):
    gen = torch.Generator(device=hopper).manual_seed(m + k)
    x = (torch.randn((m, k), generator=gen, device=hopper) * 1.5).to(x_dtype)
    qw = _ints(gen, SP.max_w, (k, n), hopper)
    w = ops.dense_store_weights(qw, 2) if store == "dense" \
        else packing.pack_weights(qw, SP)
    args = (qw.sum(dim=0, dtype=torch.int32),
            torch.tensor(3 ** -0.5, device=hopper),
            torch.tensor(2, dtype=torch.int32, device=hopper),
            torch.tensor(0.02, device=hopper),
            torch.tensor(2, dtype=torch.int32, device=hopper))
    want = ops.quantized_linear(x, w, *args, SP, backend="torch",
                                weight_store=store, out_dtype=x_dtype)
    heur = plan_lib.plan_quantized_linear(m, k, n, SP, x_dtype,
                                          weight_store=store, device=hopper)
    assert heur.op == "quantized_linear"
    for geo in plan_lib.packed_matmul_candidates(
            m, -(-k // 2), n, SP, weight_store=store, x_dtype=x_dtype,
            device=hopper):
        plan = dataclasses.replace(heur, **geo)
        got = ops.quantized_linear(x, w, *args, SP, plan=plan,
                                   weight_store=store, out_dtype=x_dtype)
        assert torch.equal(got, want), geo


@pytest.mark.parametrize("c,kv", [(1, 4), (1, 16), (16, 4), (4, 2)])
def test_every_attention_candidate_k4_equals_k3(hopper, c, kv):
    """Each K3 candidate within ATTN_TOL of the plain version, and K4 at
    the same geometry through a scrambled table bit-equal to it."""
    gen = torch.Generator(device=hopper).manual_seed(c + kv)
    b, s, h, kvh, hd, ps = 3, 256, 8, 4, 64, 16
    kf, vf = (torch.randn((b, s, kvh, hd), generator=gen, device=hopper)
              .to(torch.bfloat16) for _ in range(2))
    if kv == 16:
        cache = {"k": kf, "v": vf}
    else:
        (qk, sk), (qv, sv) = (attention.kv_quantize(t, kv) for t in (kf, vf))
        cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    npg = s // ps
    bt = torch.randperm(b * npg, generator=gen, device=hopper) \
        .reshape(b, npg).to(torch.int32)
    pool = {}
    for name, t in cache.items():
        pool[name] = torch.empty((b * npg, ps, *t.shape[2:]), dtype=t.dtype,
                                 device=hopper)
        pool[name][bt.long()] = t.reshape(b, npg, ps, *t.shape[2:])
    q = torch.randn((b, c, h, hd), generator=gen, device=hopper)
    vl = torch.tensor([256, 100, 0], dtype=torch.int32, device=hopper)
    qpos = (torch.clamp(vl, min=c)[:, None] - c + torch.arange(
        c, device=hopper)[None, :]).to(torch.int32)
    want = ua.attention_decode_torch(q, cache, vl, qpos, kv_bits=kv, hd=hd,
                                     block_k=512)
    dt = torch.bfloat16 if kv == 16 else None
    p3 = plan_lib.plan_attention_decode(b, c, s, h, kvh, hd, kv,
                                        cache_dtype=dt, device=hopper)
    p4 = plan_lib.plan_attention_decode(b, c, s, h, kvh, hd, kv,
                                        page_size=ps, cache_dtype=dt,
                                        device=hopper)
    cands = plan_lib.attention_decode_candidates(b, c, s, h, kvh, hd, kv,
                                                 align=ps, cache_dtype=dt)
    assert len(cands) > 1
    for geo in cands:
        got = ua.attention_decode_cuda(q, cache, vl, qpos, kv_bits=kv, hd=hd,
                                       plan=dataclasses.replace(p3, **geo))
        assert torch.allclose(got, want, rtol=autotune.ATTN_TOL,
                              atol=autotune.ATTN_TOL), geo
        geo4 = plan_lib.attention_decode_geometry(
            b, c, s, h, kvh, hd, kv, tile_rows=geo["tile_rows"],
            split_rows=geo["split_rows"], page_size=ps, cache_dtype=dt)
        got4 = ua.attention_decode_paged_cuda(
            q, pool, vl, qpos, bt, kv_bits=kv, hd=hd,
            plan=dataclasses.replace(p4, **geo4))
        assert torch.equal(got4, got), geo


@pytest.mark.parametrize("spec", ["W2A2/int16xP2s8", "W1A1/int8xP2s4",
                                  "W2A2/int32xP2s16"])
@pytest.mark.parametrize("cin,cout,hw", [(32, 64, 20), (8, 24, 9)])
def test_every_k5_candidate_bit_equal(hopper, spec, cin, cout, hw):
    sp = PackSpec.parse(spec)
    gen = torch.Generator(device=hopper).manual_seed(cin + cout)
    qx = _ints(gen, sp.max_a, (2, hw, hw, cin), hopper)
    qw = _ints(gen, sp.max_w, (7, 7, cin, cout), hopper)
    xp = packing.pack_activations(qx, sp, axis=-1)
    wp = packing.pack_weights(qw, sp, axis=2)
    want = ops.packed_conv2d(xp, wp, sp, backend="torch")
    heur = plan_lib.plan_packed_conv2d(tuple(xp.shape), tuple(wp.shape), sp,
                                       device=hopper)
    cands = plan_lib.packed_conv2d_candidates(tuple(xp.shape),
                                              tuple(wp.shape), sp,
                                              device=hopper)
    assert cands
    for geo in cands:
        got = ops.packed_conv2d(xp, wp, sp,
                                plan=dataclasses.replace(heur, **geo))
        assert torch.equal(got, want), geo


def test_tuners_store_adopted_winners(hopper):
    e = autotune.tune_quantized_linear(4, 512, 256, SP, torch.bfloat16,
                                       device=hopper)
    assert e["bit_equal"] and e["candidates"] > 1 and e["heuristic_us"] > 0
    p = plan_lib.plan_quantized_linear(4, 512, 256, SP, torch.bfloat16,
                                       weight_store="lanes", device=hopper)
    assert p.source == "tuned" and (p.block_m, p.block_k, p.splits) == (
        e["block_m"], e["block_k"], e["splits"])
    e = autotune.tune_attention_decode(2, 1, 128, 8, 4, 64, kv_bits=4,
                                       device=hopper)
    assert e["within_tol"] and e["max_err"] <= 1e-3
    for ps in (None, 16):
        p = plan_lib.plan_attention_decode(2, 1, 128, 8, 4, 64, 4,
                                           page_size=ps, device=hopper)
        assert p.source == "tuned" and p.split_rows == e["split_rows"]
    e = autotune.tune_packed_conv2d((1, 16, 16, 4), (7, 7, 4, 16), SP,
                                    device=hopper)
    assert e["bit_equal"] and e["candidates"] > 1
    e = autotune.tune_matmul_layout(8, 256, 128, SP, device=hopper)
    assert e["bit_equal"] and e["candidates"] >= 4


def test_engine_and_cli_from_a_tuned_cache(hopper, tmp_path, monkeypatch,
                                           capsys):
    cfg = configs.get_config("stablelm-1.6b", reduced=True)
    params = lm.init_params(cfg, torch.Generator(hopper).manual_seed(0),
                            hopper)
    ecfg = engine_lib.EngineConfig(max_batch=2, max_len=64, autotune=True)
    eng = engine_lib.ServingEngine(cfg, params, config=ecfg, device=hopper)
    assert {r["source"] for r in eng.plan_report()} == {"tuned"}
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(engine_lib.Request(i, rng.integers(
            0, cfg.vocab_size, 9).astype(np.int32), max_new_tokens=5))
    done = eng.run_to_completion()
    assert [len(r.output) for r in done] == [5, 5]
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "c.json"))
    autotune.reset_active_cache()
    serve_cli.main(["--arch", "stablelm-1.6b", "--reduced", "--requests",
                    "2", "--autotune"])
    assert "autotune cache saved to" in capsys.readouterr().out
    autotune.reset_active_cache()
    rep = serve_cli.main(["--arch", "stablelm-1.6b", "--reduced",
                          "--requests", "2", "--metrics"])
    assert rep["autotune"]["tuned"] == 0
    assert {p["source"] for p in rep["plans"]} == {"tuned"}


def test_cnn_autotune_logits_bit_equal(hopper):
    """The CNN's tuned layouts and tiles change no bit of the logits: the
    integer convs are exact and the fused epilogue is bit-equal to the
    eager one."""
    cfg = configs.get_config("sparq-cnn", reduced=True)
    params = cnn.init_params(cfg, torch.Generator(hopper).manual_seed(0),
                             device=hopper)
    xs = (2, 24, 24, 3)
    x = torch.rand(xs, generator=torch.Generator(hopper).manual_seed(1),
                   device=hopper)
    base = cnn.prepare_packed_params(params, cfg, x_shape=xs)
    want = cnn.forward(base, cfg, x, quant_mode="packed",
                       plans=cnn.layer_plans(base, cfg, xs))
    tuned = cnn.prepare_packed_params(params, cfg, x_shape=xs, autotune=True)
    plans = cnn.layer_plans(tuned, cfg, xs, autotune=True)
    assert {p.source for p in plans} == {"tuned"}
    got = cnn.forward(tuned, cfg, x, quant_mode="packed", plans=plans)
    assert torch.equal(got, want)
