"""The train-step cases of the nine LM archs beyond stablelm-1.6b, shared
by ``tests/test_torch_train_*.py`` (the port against the reference on the
CPU), the card test of ``tests/test_torch_train.py`` and the ``train
archs`` lines of ``chip_smoke.py`` (which load this file by path).  It
imports no JAX.

Each case is an arch's reduced config in f32 under ``remat='block'`` and
two microbatches, a batch of 4 from ``data/pipeline.family_batch`` (the
VLM's image prefix and ``positions3``, the encoder-decoder's
``enc_embeds``), two steps of ``make_train_step`` at ``KW``: the first
at lr 0, the second at lr 5e-3.  Moments are 8-bit where the arch's full
config keeps them so (qwen1.5-32b, mixtral-8x22b, jamba); those three
also run with f32 moments, so that every family's update is held
element by element.

How the params are held (:func:`param_check`).  The AdamW step is
``m̂ / (√v̂ + eps)``: it scales every element's update to about lr,
however small its gradient.  Where an element's gradient sits at f32's
rounding noise -- its first moment below ``FLOOR`` (1e-4) of its leaf's
largest, or its second below ``FLOOR²`` of the leaf's -- the two sides'
backward sums, done in another order, differ there by a share of the
gradient itself, and the step carries that share into the param.  So:

- f32 moments: every element within ``atol`` (1e-5 on the CPU), those at
  the floor within ``10 * atol`` (mixtral-8x7b's worst is 2.4e-5: an
  expert's gradient of 1e-9, 6 % apart between the two sides);
- 8-bit moments: m and v are int8 codes of their 256-block's absmax /
  127.  A code can round the other way on the two sides (at most one
  apart, in at most ``FLIP_SHARE`` of the codes), and the next update of
  that element then starts from a moment one code apart; and where v
  rounds to code 0 while m does not, the update is ``m̂ / eps`` (28 at lr
  5e-3 on reduced qwen1.5-32b's head), so a 1e-3 difference in the
  gradient moves the param by 0.02.  Both are the reference's own
  arithmetic.  Every element held -- moments above the floor (code 0 is
  below it), no flipped code before the last update -- is within
  ``atol``; the others are counted, not held.

The card against the CPU (:func:`card_steps`): three steps with f32
moments; two with 8-bit ones.  After an 8-bit update the elements it
moved by ``m̂ / eps`` differ between the two devices by up to 0.02, and
a third step's forward reads them: its loss moved 1.6e-4 (qwen1.5-32b)
and 3.2e-4 (mixtral-8x22b) relative and jamba's held head params 1e-3
on the first card run, so from then on nothing is held to 1e-4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import bridge, configs, tree as tree_lib
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw
from repro_torch.train import checkpoint

KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
ARCHS = ("qwen1.5-32b", "granite-3-8b", "minicpm-2b", "mixtral-8x7b",
         "mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-1.3b",
         "qwen2-vl-2b", "seamless-m4t-medium")
#: the archs whose full configs keep 8-bit moments
EIGHTBIT = ("qwen1.5-32b", "mixtral-8x22b", "jamba-1.5-large-398b")
#: shorter rows where the reference's op-by-op recurrences are slow
SEQ = {"jamba-1.5-large-398b": 8, "xlstm-1.3b": 8}
BATCH, STEPS = 4, 2
FLOOR = 1e-4
FLIP_SHARE = 1e-3


def card_steps(eightbit: bool) -> int:
    """Steps the card takes against the CPU (the module docstring)."""
    return STEPS if eightbit else 3


def cases(names) -> list:
    """(name, eightbit) pairs: each arch with its own moments, and the
    8-bit archs with f32 moments too."""
    return [(n, e) for n in names
            for e in ((True, False) if n in EIGHTBIT else (False,))]


def case_id(case) -> str:
    return f"{case[0]}-{'8bit' if case[1] else 'f32'}"


def with_settings(cfg, eightbit: bool):
    """``cfg`` (either package's) in f32, remat 'block', two microbatches,
    the given moments."""
    return cfg.replace(param_dtype="float32", compute_dtype="float32",
                       parallel=dataclasses.replace(
                           cfg.parallel, remat="block", microbatches=2,
                           eightbit_moments=eightbit))


def port_config(name: str, eightbit: bool):
    return with_settings(configs.get_config(name, reduced=True), eightbit)


def batches(cfg, steps=STEPS, seed=0) -> list:
    """``steps`` batches of BATCH rows with their labels, from one numpy
    Generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b, labels = pipeline.family_batch(cfg, rng, b=BATCH,
                                          s=SEQ.get(cfg.name, 16))
        out.append(dict(b, labels=labels))
    return out


def moment_codes(state) -> dict:
    """{(moment, param path): int8 codes [numel]} of an 8-bit state."""
    out = {}
    for mom in ("m", "v"):
        for path, leaf in tree_lib.flatten_with_path(
                state["opt_state"][mom], is_leaf=adamw.is_moment):
            out[mom, path] = leaf["q"].reshape(-1)
    return out


def code_flips(got, want) -> dict:
    """{param path: bool [numel]}: the elements whose m or v code differs
    between the 8-bit states ``got`` and ``want``.  Fails where a code is
    more than one apart (the blocks' scales are held through the params:
    :func:`param_check`)."""
    a, b = moment_codes(got), moment_codes(want)
    flips = {}
    for key, q in b.items():
        d = (a[key].cpu().to(torch.int32) - q.to(torch.int32)).abs()
        assert int(d.max()) <= 1, (key, int(d.max()))
        flips[key[1]] = flips.get(key[1], torch.zeros_like(d, dtype=bool)) \
            | (d > 0)
    return flips


def merge_flips(acc: dict, new: dict) -> dict:
    return {k: acc[k] | v if k in acc else v for k, v in new.items()}


def _moment(node, numel) -> torch.Tensor:
    if adamw.is_moment(node):
        node = node["q"].to(torch.float64) * node["scale"].to(torch.float64)
    return node.reshape(-1)[:numel].to(torch.float64)


def param_check(got, want, atol, flips=None) -> dict:
    """Hold ``got``'s params to ``want``'s as the module docstring says;
    ``want``'s moments pick the held elements, ``flips`` (8-bit) the
    elements whose codes differed before the last update.  Returns the
    worst differences and the count of elements not held."""
    eight = flips is not None
    m = dict(tree_lib.flatten_with_path(want["opt_state"]["m"],
                                        is_leaf=adamw.is_moment))
    v = dict(tree_lib.flatten_with_path(want["opt_state"]["v"],
                                        is_leaf=adamw.is_moment))
    rep = {"held_max": 0.0, "floor_max": 0.0, "not_held": 0, "numel": 0}
    for (path, p), (_, q) in zip(tree_lib.flatten_with_path(got["params"]),
                                 tree_lib.flatten_with_path(want["params"])):
        d = (p.detach().cpu().to(torch.float64).reshape(-1)
             - q.to(torch.float64).reshape(-1)).abs()
        mm, vv = _moment(m[path], d.numel()), _moment(v[path], d.numel())
        held = (mm.abs() >= FLOOR * mm.abs().max()) \
            & (vv >= FLOOR ** 2 * vv.max())
        if eight and path in flips:
            held &= ~flips[path][:d.numel()]
        worst = float(d[held].max()) if held.any() else 0.0
        assert worst <= atol, (path, worst)
        rep["held_max"] = max(rep["held_max"], worst)
        rest = float(d[~held].max()) if (~held).any() else 0.0
        if not eight:
            assert rest <= 10 * atol, (path, rest)
            rep["floor_max"] = max(rep["floor_max"], rest)
        rep["not_held"] += int((~held).sum())
        rep["numel"] += d.numel()
    if eight:
        n_flip = sum(int(f.sum()) for f in flips.values())
        n_codes = sum(f.numel() for f in flips.values())
        assert n_flip <= FLIP_SHARE * n_codes, (n_flip, n_codes)
        rep["flipped_codes"] = n_flip
    return rep


def metrics_check(got, want, rtol, where="") -> None:
    """``lr`` equal; ``loss``, ``ce`` and ``grad_norm`` within ``rtol``."""
    assert float(got["lr"]) == float(want["lr"]), where
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=f"{where} {k}")


def to_cpu(state):
    """A port state (any device) as CPU tensors, through numpy."""
    return bridge.from_repro(bridge.to_numpy(state), device="cpu")


def cli_trains(tmp_path, name):
    """``python -m repro_torch.launch.train --arch <name> --reduced --steps
    2`` (16-token rows, the default batch of 4): two steps, the step-2
    checkpoint written, every param finite."""
    state, step = train_cli.main(["--arch", name, "--reduced", "--steps",
                                  "2", "--seq-len", "16", "--ckpt-dir",
                                  str(tmp_path), "--device", "cpu"])
    assert step == 2 and checkpoint.latest_step(tmp_path) == 2
    assert all(torch.isfinite(x.float()).all()
               for x in tree_lib.leaves(state["params"]))
