"""The port's training path against the reference at reduced size
(``stablelm-1.6b --reduced``): the data stream byte-equal, the train step
from one state carried across by ``bridge`` (W2A2 QAT and quantization
off; remat and microbatches as the config sets them), remat on/off and
microbatches 1/2 within the port, the fake-quant prefill step, the
``Trainer``'s fault tolerance (the counterparts of ``tests/test_fault.py``)
and the CLI.  The reference runs op by op (``jax.disable_jit``), so no
fused rounding of the compiled reference moves a 2-bit lattice.

Tolerances: f32 compute -- loss, ce and grad_norm within 1e-5 relative
and params within 1e-5 absolute after three steps (the matmuls sum in
another order; no lattice flipped on these inputs, which the bound would
show: a flip moves a weight by a whole step); bf16 compute -- one step,
loss within 1e-3 and grad_norm within 2e-2 relative (bf16 products and
the bf16 logistic round on both sides, but each library sums in its own
order, and with 2-bit activations a one-ulp difference can flip a
lattice value).

Reference imports happen inside the ``ref`` fixture, so the card's
machine (no JAX) collects this file and runs its ``cuda`` test: the train
step on the card against the port's own CPU run.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_cases as train_cases  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import ParallelConfig as TP  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.data.pipeline import DataConfig, \
    SyntheticLMStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, Trainer  # noqa: E402

torch.set_num_threads(2)
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty: no cache file left by a tuning
    run can change a plan or a packed layout here."""
    from repro_torch.kernels import autotune as port_autotune
    old = port_autotune.active_cache()
    port_autotune.set_active_cache(port_autotune.TuningCache(device="cpu"))
    yield
    port_autotune.set_active_cache(old)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.configs.base import ParallelConfig
    from repro.core.quant import QuantConfig
    from repro.data import pipeline
    from repro.launch import steps
    from repro.models import lm
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 ParallelConfig=ParallelConfig,
                                 QuantConfig=QuantConfig, pipeline=pipeline,
                                 steps=steps, lm=lm)


def _tcfg(dtype="float32", qat=True, kv_bits=0, **par):
    c = tconfigs.get_config("stablelm-1.6b", reduced=True)
    return c.replace(param_dtype=dtype, compute_dtype=dtype,
                     quant=TQ(enabled=qat, w_bits=2, a_bits=2,
                              kv_bits=kv_bits),
                     parallel=TP(**{"remat": c.parallel.remat,
                                    "microbatches": c.parallel.microbatches,
                                    **par}))


def _jcfg(ref, tcfg):
    c = ref.configs.get_config("stablelm-1.6b", reduced=True)
    q, p = tcfg.quant, tcfg.parallel
    return c.replace(param_dtype=tcfg.param_dtype,
                     compute_dtype=tcfg.compute_dtype,
                     quant=ref.QuantConfig(enabled=q.enabled, w_bits=2,
                                           a_bits=2, kv_bits=q.kv_bits),
                     parallel=ref.ParallelConfig(
                         remat=p.remat, microbatches=p.microbatches))


def _stream(cfg, seed=0, seq=16, batch=4):
    return SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=seed))


def _port_state(tcfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tsteps.make_train_state(tlm.init_params(tcfg, gen, device="cpu"),
                                   cfg=tcfg)


def _param_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)))


def test_data_batches_byte_equal(ref):
    for seed, step in ((0, 0), (0, 5), (11, 3)):
        cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=4,
                         seed=seed)
        got = SyntheticLMStream(cfg).batch_at(step)
        want = ref.pipeline.SyntheticLMStream(
            ref.pipeline.DataConfig(**vars(cfg))).batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("dtype,qat,steps", [("float32", True, 3),
                                             ("float32", False, 3),
                                             ("bfloat16", True, 1)])
def test_train_step_matches_reference(ref, dtype, qat, steps):
    """From one reference state carried across by ``bridge``: the metrics
    of every step, then every param, under the config's remat='block' and
    microbatches=2."""
    jax, jnp = ref.jax, ref.jnp
    tcfg = _tcfg(dtype, qat)
    jcfg = _jcfg(ref, tcfg)
    assert tsteps.quant_mode_for(tcfg, "train") == ("qat" if qat else "none")
    jparams = ref.lm.init_params(jax.random.PRNGKey(1), jcfg)
    jstate = ref.steps.make_train_state(jparams, cfg=jcfg)
    tstate = bridge.from_repro(jax.device_get(jstate), device="cpu")
    jstep = ref.steps.make_train_step(jcfg, **KW)
    tstep = tsteps.make_train_step(tcfg, **KW)
    data = _stream(tcfg)
    rtol = {"float32": dict(loss=1e-5, ce=1e-5, grad_norm=1e-5),
            "bfloat16": dict(loss=1e-3, ce=1e-3, grad_norm=2e-2)}[dtype]
    for i in range(steps):
        batch = data.batch_at(i)
        with jax.disable_jit():
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        assert float(tm["lr"]) == float(jm["lr"])
        for k, tol in rtol.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"step {i} {k}")
    assert int(tstate["step"]) == steps
    if dtype == "float32":
        want = bridge.from_repro(jax.device_get(jstate["params"]), "cpu")
        assert _param_diff(tstate["params"], want) < 1e-5


def test_remat_and_microbatches_within_the_port():
    """remat on / off: bit-equal (the backward recomputes the same
    lattices); microbatches 1 / 2: within 1e-5 (the loss is a mean of two
    half-batch means, summed in another order)."""
    batch = _stream(_tcfg()).batch_at(0)
    out = {}
    for remat, micro in (("block", 2), ("none", 2), ("block", 1)):
        cfg = _tcfg(remat=remat, microbatches=micro)
        out[remat, micro] = tsteps.make_train_step(cfg, **KW)(
            _port_state(cfg), batch)
    (a, ma), (b, mb), (c, mc) = (out["block", 2], out["none", 2],
                                 out["block", 1])
    for k in ("loss", "ce", "grad_norm"):
        assert float(ma[k]) == float(mb[k])
        np.testing.assert_allclose(float(mc[k]), float(ma[k]), rtol=1e-5)
    assert _param_diff(a["params"], b["params"]) == 0.0
    assert _param_diff(a["params"], c["params"]) < 1e-5


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_prefill_step_matches_reference(ref, kv_bits):
    """The fake-quant prefill: last logits within 1e-4, the filled cache
    rows within 1e-5 (kv 16) or their words and scales equal (kv 4)."""
    jax, jnp = ref.jax, ref.jnp
    tcfg = _tcfg(kv_bits=kv_bits)
    jcfg = _jcfg(ref, tcfg)
    assert tsteps.quant_mode_for(tcfg, "prefill") == "qat"
    jparams = ref.lm.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = bridge.from_repro(jax.device_get(jparams), device="cpu")
    tokens = _stream(tcfg, seq=12, batch=3).batch_at(0)["tokens"]
    with jax.disable_jit():
        jl, jc = ref.steps.make_prefill_step(jcfg, 24)(
            jparams, {"tokens": jnp.asarray(tokens)})
    tl, tc = tsteps.make_prefill_step(tcfg, 24)(tparams, {"tokens": tokens})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert len(tc) == len(jc) == tcfg.num_layers
    for t, j in zip(tc, jc):
        for name, want in j["attn"].items():
            got = bridge.to_numpy(t["attn"][name])
            want = np.asarray(want)
            if want.dtype.name == "bfloat16":
                want = want.astype(np.float32)
            assert got.shape == want.shape, name
            if kv_bits == 16:
                np.testing.assert_allclose(got, want, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_attention_matches_reference(ref, chunk):
    """``attention.chunked_attention`` against the reference's
    ``_chunked_attention`` with GQA (4 query heads on 2 kv heads) and the
    causal mask: with chunk 4 over 10 queries (two recomputed chunks and
    a tail) and with one chunk; output and the gradients of q, k and v
    within 1e-5 (f32 sums in another order)."""
    jax, jnp = ref.jax, ref.jnp
    from repro.models import attention as jatt

    from repro_torch.models import attention as tatt
    rng = np.random.default_rng(chunk)
    q, g = (rng.normal(size=(2, 10, 4, 8)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(2, 10, 2, 8)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))

    def jfn(q_, k_, v_):
        jp = jnp.asarray(pos)
        return jatt._chunked_attention(
            q_, lambda: (k_, v_),
            lambda qp: jp[:, None, :] <= qp[:, :, None], jp, chunk)

    with jax.disable_jit():
        jy, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
        jg = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    ty = tatt.chunked_attention(tq, tk, tv, tatt._causal(tpos, 10), tpos,
                                chunk)
    tg = torch.autograd.grad(ty, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---- the Trainer (counterparts of tests/test_fault.py) ----

def _tiny():
    return tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=128, param_dtype="float32", compute_dtype="float32",
        quant=TQ(enabled=True, w_bits=2, a_bits=2))


def _data(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=11)


def _loop(tmp, total, every, **kw):
    kw.setdefault("log_every", 100)
    return TrainLoopConfig(total_steps=total, checkpoint_every=every,
                           checkpoint_dir=str(tmp),
                           async_checkpoint=kw.pop("async_", False), **kw)


@pytest.mark.parametrize("eightbit", [False, True])
def test_crash_resume_is_bit_identical(tmp_path, eightbit):
    """12 steps straight against 6 steps, a 'crash', a resume to 12: every
    param and moment equal (data, optimizer and step all restored)."""
    cfg = _tiny().replace(parallel=TP(remat="block", microbatches=2,
                                      eightbit_moments=eightbit))
    a, _ = Trainer(cfg, _loop(tmp_path / "a", 12, 100), _data(cfg), seed=5,
                   device="cpu").run()
    Trainer(cfg, _loop(tmp_path / "b", 6, 6, async_=True), _data(cfg),
            seed=5, device="cpu").run()
    assert tckpt.latest_step(tmp_path / "b") == 6
    b, step = Trainer(cfg, _loop(tmp_path / "b", 12, 100), _data(cfg),
                      seed=5, device="cpu").run()
    assert step == 12 and int(b["step"]) == 12
    for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_preemption_triggers_checkpoint(tmp_path):
    cfg = _tiny()
    t = Trainer(cfg, _loop(tmp_path, 50, 1000), _data(cfg), seed=1,
                device="cpu")
    t._preempted = True                 # SIGTERM arrived after construction
    _, stopped_at = t.run()
    assert stopped_at == 1
    assert tckpt.latest_step(tmp_path) == 1


def test_straggler_detection(tmp_path):
    cfg = _tiny()
    events = []
    t = Trainer(cfg, _loop(tmp_path, 12, 1000, straggler_factor=2.0),
                _data(cfg), seed=2, straggler_cb=events.append, device="cpu")
    orig, calls = t.step_fn, {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 10:
            import time
            time.sleep(0.5)
        return orig(state, batch)

    t.step_fn = slow_step
    t.run()
    assert any(e["step"] == 9 for e in events), events


def test_loss_falls_during_training(tmp_path):
    cfg = _tiny()
    t = Trainer(cfg, _loop(tmp_path, 60, 1000, log_every=5), _data(cfg),
                seed=3, device="cpu",
                train_step_kwargs={"peak_lr": 3e-3, "warmup_steps": 10,
                                   "total_steps": 60})
    t.run()
    first, last = t.metrics_log[0]["loss"], t.metrics_log[-1]["loss"]
    assert last < first - 0.1, (first, last)


def test_cli_trains_and_checkpoints(tmp_path):
    state, step = tcli.main(["--arch", "stablelm-1.6b", "--reduced",
                             "--steps", "2", "--seq-len", "8", "--batch",
                             "2", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu"])
    assert step == 2 and tckpt.latest_step(tmp_path) == 2
    assert all(torch.isfinite(x.float()).all()
               for x in tree_lib.leaves(state["params"]))


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, _loop("unused", 1, 1), _data(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore("unused")


def test_split_micro_refuses_a_batch_it_does_not_divide():
    """A batch of 10 in 4 microbatches (``torch.chunk`` made 3, 3, 3 and 1
    rows and the step still divided by 4) and a batch of 2 in 4 (an
    IndexError before) are refused, as the reference's reshape refuses
    them; the train step refuses such a batch before any forward."""
    batch = {"tokens": torch.zeros(10, 8, dtype=torch.int32),
             "labels": torch.zeros(10, 8, dtype=torch.int32)}
    with pytest.raises(ValueError, match="10 does not split into 4"):
        tsteps._split_micro(batch, 4)
    with pytest.raises(ValueError, match="2 does not split into 4"):
        tsteps._split_micro({k: v[:2] for k, v in batch.items()}, 4)
    cfg = _tcfg(microbatches=4)
    with pytest.raises(ValueError, match="does not split into 4"):
        tsteps.make_train_step(cfg, **KW)(
            _port_state(cfg), _stream(cfg, batch=10).batch_at(0))


def test_split_micro_splits_positions3_on_its_batch_axis():
    """``positions3`` [3, B, S] splits on axis 1, everything else on axis
    0, into equal parts in order."""
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 9, (4, 6), generator=g),
             "embeds": torch.randn(4, 2, 5, generator=g),
             "positions3": torch.randint(0, 9, (3, 4, 8), generator=g)}
    parts = tsteps._split_micro(batch, 2)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        rows = slice(2 * i, 2 * i + 2)
        assert torch.equal(part["tokens"], batch["tokens"][rows])
        assert torch.equal(part["embeds"], batch["embeds"][rows])
        assert torch.equal(part["positions3"], batch["positions3"][:, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("stablelm-1.6b", False)]
                         + train_cases.cases(train_cases.ARCHS),
                         ids=train_cases.case_id)
def test_train_step_on_the_card_matches_the_cpu(case):
    """Train steps on the card against the port's CPU run from the same
    state: metrics within 1e-4 relative and params within 1e-4 (cuBLAS
    sums in another order than the CPU's BLAS).  stablelm: three steps
    of the reduced W2A2 step (remat, two microbatches, f32), every param;
    the nine other LM archs at ``torch_train_cases``' settings (reduced,
    f32, remat 'block', two microbatches, 8-bit moments where the config
    keeps them), three steps with f32 moments and two with 8-bit ones
    (``card_steps``: a third step reads params an 8-bit update moved by
    m̂ / eps, which differ by up to 0.02 between the devices), params as
    ``torch_train_cases.param_check`` holds them (the elements at f32's
    noise floor within 1e-3; with 8-bit moments, codes at most one
    apart, the elements at a flipped code or a zero v code counted, not
    held)."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card")
    name, eightbit = case
    stablelm = name == "stablelm-1.6b"
    cfg = _tcfg() if stablelm else train_cases.port_config(name, eightbit)
    cpu = _port_state(cfg, seed=3)
    card = bridge.from_repro(bridge.to_numpy(cpu), device="cuda")
    step = tsteps.make_train_step(cfg, **KW)
    data = ([_stream(cfg).batch_at(i) for i in range(3)] if stablelm
            else train_cases.batches(cfg,
                                     steps=train_cases.card_steps(eightbit)))
    flips = {} if eightbit else None
    for i, batch in enumerate(data):
        cpu, mc = step(cpu, batch)
        card, mg = step(card, batch)
        train_cases.metrics_check(mg, mc, 1e-4, f"step {i}")
        back = train_cases.to_cpu(card)
        if eightbit:
            now = train_cases.code_flips(back, cpu)
            if i < len(data) - 1:
                flips = train_cases.merge_flips(flips, now)
    if stablelm:
        assert _param_diff(back["params"], cpu["params"]) < 1e-4
    else:
        train_cases.param_check(back, cpu, 1e-4, flips)
