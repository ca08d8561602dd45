"""The port's examples (``repro_torch.examples.quickstart`` and
``serve_quantized``) against the reference scripts ``examples/
quickstart.py`` and ``examples/serve_quantized.py``, on the CPU: the
quickstart's printed numbers (the packed linear's error against the float
oracle, the exact lattice dot, the k_tile table) equal the reference
script's; ``serve_quantized``'s param-byte and cache-byte lines equal the
reference script's, its greedy tokens equal the reference engine's (run op
by op) on the same weights carried across the bridge, and its two-shard
(``--model-parallel 2``) and two-replica (``--data-parallel 2``) runs give
the one-shard tokens."""

import functools
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.quant import QuantConfig as JQ  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.examples import quickstart, serve_quantized  # noqa: E402
from repro_torch.kernels import autotune as tautotune  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def empty_caches():
    """Pin both packages' tuning caches empty: the base lane layout."""
    old_t, old_j = tautotune.active_cache(), jautotune.active_cache()
    tautotune.set_active_cache(tautotune.TuningCache(device="cpu"))
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu"))
    yield
    tautotune.set_active_cache(old_t)
    jautotune.set_active_cache(old_j)


@functools.lru_cache(maxsize=None)
def _reference_script(name) -> str:
    """The reference script's standard output, run as its docstring says
    (its own process, ``PYTHONPATH=src``, JAX on the CPU)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _run(main, argv, capsys):
    out = main(argv)
    return out, capsys.readouterr().out


def test_quickstart_matches_reference_script(capsys):
    got, text = _run(quickstart.main, ["--device", "cpu"], capsys)
    want = _reference_script("quickstart.py")
    lines, ref = text.splitlines(), want.splitlines()
    # the spec and the weight bytes, word for word
    assert lines[:2] == ref[:2]
    err = float(re.search(r"max err: (\S+)", text).group(1))
    ref_err = float(re.search(r"max err: (\S+)", want).group(1))
    assert err == ref_err == got["max_err"]
    # the lattice dot exact on the port's kernel (its plain version here),
    # as on the reference's Pallas kernel
    assert "EXACT match with integer oracle" in ref[3]
    assert re.fullmatch(r"ulppack_matmul \(plain version on cpu\): EXACT "
                        r"match with integer oracle", lines[3])
    # the overflow-free table and its caption, line for line
    at, ref_at = lines.index(""), ref.index("")
    assert lines[at:] == ref[ref_at:]
    assert got["region"][(4, 4)] == 0 and got["region"][(2, 2)] == 14


def _ref_tokens(cfg_port, params) -> list:
    """The reference engine, op by op, over the example's weights carried
    across the bridge: the example's config, engine config and requests."""
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        d_model=128, num_heads=8, num_kv_heads=8, d_ff=384, num_layers=4,
        vocab_size=2048, param_dtype="float32", compute_dtype="float32",
        quant=JQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4))
    assert jcfg.param_counts() == cfg_port.param_counts()
    jp = jax.tree.map(jax.numpy.asarray, bridge.to_repro(params))
    rng = np.random.default_rng(0)
    with jax.disable_jit():
        eng = jengine.ServingEngine(jcfg, jp, config=jengine.EngineConfig(
            max_batch=2, max_len=64, packed=True))
        reqs = [jengine.Request(
            uid=i, prompt=rng.integers(0, jcfg.vocab_size, 6).astype(
                np.int32), max_new_tokens=8) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
    return [r.output for r in reqs]


def test_serve_quantized_matches_reference(capsys):
    """The byte lines equal the reference script's; the served tokens
    equal the reference engine's on the same weights."""
    got, text = _run(serve_quantized.main, ["--device", "cpu"], capsys)
    want = _reference_script("serve_quantized.py")
    for prefix in ("serving params:", "kv cache:"):
        mine = [ln for ln in text.splitlines() if ln.startswith(prefix)]
        ref = [ln for ln in want.splitlines() if ln.startswith(prefix)]
        assert mine == ref and len(ref) == 1, prefix
    assert len(got) == 4 and all(len(o) == 8 for o in got)
    # the example's own weights (seed 0 on the CPU), bridged
    cfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        d_model=128, num_heads=8, num_kv_heads=8, d_ff=384, num_layers=4,
        vocab_size=2048, param_dtype="float32", compute_dtype="float32",
        quant=TQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4))
    params = tlm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                             "cpu")
    want_tokens = _ref_tokens(cfg, params)
    assert all(len(o) == 8 for o in want_tokens)
    assert got == want_tokens


@pytest.mark.parametrize("argv,line", [
    (["--model-parallel", "2"],
     r"serving mesh: \{'data': 1, 'model': 2\} over 1 host devices"),
    (["--data-parallel", "2"],
     r"fleet: host has 1 devices \(< 2\); falling back to 2 process-local "
     r"replicas sharing the host")], ids=["model-parallel", "data-parallel"])
def test_serve_quantized_parallel_tokens_equal_one_shard(argv, line, capsys):
    """Two shards on the one CPU device (the mesh the example prints) and
    two replicas behind the Router (the reference's fallback line) serve
    the one-shard tokens."""
    one, _ = _run(serve_quantized.main, ["--device", "cpu"], capsys)
    got, text = _run(serve_quantized.main, ["--device", "cpu", *argv],
                     capsys)
    assert re.search(line, text), text
    if "--model-parallel" in argv:
        assert "shard plan:" in text and "'model_shards': 2" in text
    assert got == one
