"""The port's pipeline (``repro_torch.parallel.pipeline``) against
``repro.parallel.pipeline``: ``gpipe`` over two tanh stages equal to the
reference's run on 2 forced host devices in a subprocess (as
``tests/test_pipeline.py`` runs it) within 1e-5, on a CPU mesh listing one
device twice; gradients through ``gpipe`` bit-equal to those through the
stages applied in sequence; ``bubble_fraction`` equal; and the reduced
stablelm's packed serving blocks stacked into two stages, through
``gpipe`` bit-equal to the blocks in sequence, with one plain K2 call a
packed linear a microbatch (the CPU counterpart of ``chip_smoke.py``'s
``pipeline`` line)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.kernels import ulppack_matmul  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402
from repro_torch.serve import prepare  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = Mesh(["cpu", "cpu"], ("pod",))


@pytest.fixture(autouse=True)
def empty_port_cache():
    from repro_torch.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _inputs():
    rng = np.random.default_rng(0)
    d = 16
    w = (rng.normal(size=(2, d, d)) / np.sqrt(d)).astype(np.float32)
    xs = rng.normal(size=(4, 3, d)).astype(np.float32)   # 4 micro x 3
    return w, xs


def _stage(params, x):
    return torch.tanh(x @ params)


GPIPE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import gpipe, bubble_fraction
    mesh = jax.make_mesh((2,), ("pod",))
    d = np.load(sys.argv[1])
    out = gpipe(lambda p, x: jnp.tanh(x @ p), jnp.asarray(d["w"]),
                jnp.asarray(d["xs"]), mesh=mesh, axis="pod")
    np.save(sys.argv[2], np.asarray(out))
    print("PIPELINE_OK", bubble_fraction(4, 2), bubble_fraction(7, 3))
""")


def test_gpipe_matches_reference(tmp_path):
    pytest.importorskip("jax")
    w, xs = _inputs()
    np.savez(tmp_path / "in.npz", w=w, xs=xs)
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", GPIPE_SCRIPT,
                        str(tmp_path / "in.npz"), str(tmp_path / "o.npy")],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert "PIPELINE_OK" in r.stdout, (r.stdout[-1500:], r.stderr[-1500:])
    got = pipeline.gpipe(_stage, torch.from_numpy(w), torch.from_numpy(xs),
                         mesh=MESH, axis="pod")
    np.testing.assert_allclose(got.numpy(), np.load(tmp_path / "o.npy"),
                               rtol=1e-5, atol=1e-5)
    want = [float(v) for v in r.stdout.split()[-2:]]
    assert [pipeline.bubble_fraction(4, 2),
            pipeline.bubble_fraction(7, 3)] == want
    assert pipeline.bubble_fraction(4, 2) == 0.2


def test_gpipe_gradients_bit_equal_to_sequential():
    w, xs = _inputs()
    wp = torch.from_numpy(w).requires_grad_(True)
    xp = torch.from_numpy(xs).requires_grad_(True)
    out = pipeline.gpipe(_stage, wp, xp, mesh=MESH, axis="pod")
    (out * out).sum().backward()
    ws = torch.from_numpy(w).requires_grad_(True)
    xq = torch.from_numpy(xs).requires_grad_(True)
    seq = torch.stack([_stage(ws[1], _stage(ws[0], xq[m]))
                       for m in range(xs.shape[0])])
    (seq * seq).sum().backward()
    assert torch.equal(out, seq)
    assert torch.equal(wp.grad, ws.grad) and torch.equal(xp.grad, xq.grad)


def test_packed_blocks_in_two_stages():
    """Reduced stablelm's packed blocks as two stages: outputs bit-equal to
    the blocks in sequence; 4 microbatches x layers x 7 packed linears
    plain K2 calls, as in sequence."""
    cfg = configs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2,
                          lane_dtype="int16", kv_bits=4))
    params = prepare.prepare_serving_params(
        lm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
        cfg, device="cpu")
    blocks = params["layers"]
    stages = pipeline.stack_stages(blocks, 2)
    per = cfg.num_layers // 2
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.normal(size=(4, 1, 8, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None]

    def run(blk, x):
        return lm.block_apply(blk, cfg, x, positions=pos,
                              quant_mode="packed")[0]

    def stage_fn(p, x):
        for j in range(per):
            x = run(pipeline.layer(p, j), x)
        return x

    def calls():
        return ulppack_matmul.plain_calls["ulppack_matmul"]

    n0 = calls()
    with torch.no_grad():
        got = pipeline.gpipe(stage_fn, stages, xs, mesh=MESH)
        n1 = calls()
        want = []
        for m in range(xs.shape[0]):
            x = xs[m]
            for blk in blocks:
                x = run(blk, x)
            want.append(x)
    assert n1 - n0 == calls() - n1 == 4 * cfg.num_layers * 7
    assert torch.equal(got, torch.stack(want))
    with pytest.raises(ValueError, match="do not divide"):
        pipeline.stack_stages(blocks, 3)
