"""The port's train step against the reference's for one case of
``torch_train_cases`` (shared by ``tests/test_torch_train_*.py``).

From the reference's own init and train state, carried across by
``bridge.from_repro``, both packages take ``STEPS`` steps on the same
batches; the reference op by op under ``jax.disable_jit()``, so no fused
rounding of the compiled reference moves a 2-bit lattice.  Every step's
metrics: ``lr`` equal, ``loss``, ``ce`` and ``grad_norm`` within 1e-5
relative; 8-bit moments' codes at most one apart (``code_flips``); then
the params after the last step, as ``torch_train_cases.param_check``
holds them, at 1e-5.

The reference's encoder-decoder runs with ``remat='none'``: under
``jax.checkpoint`` its ``lm.forward`` gives every decoder layer the first
layer's cross K/V (the checkpointed block closes over ``enc_kv``, and the
trace of the first layer's call is reused for the others), so its remat
and plain forwards differ; the port recomputes each block with the K/V it
was given, as the reference's plain forward runs.
(``test_torch_train_encdec.py`` pins that fault.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.launch import steps as tsteps

import torch_train_cases as cases

torch.set_num_threads(2)


def reference_config(name: str, eightbit: bool):
    cfg = cases.with_settings(jconfigs.get_config(name, reduced=True),
                              eightbit)
    if cfg.is_encoder_decoder:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                       remat="none"))
    return cfg


def check_train_step(name: str, eightbit: bool, seed: int = 0) -> dict:
    jcfg = reference_config(name, eightbit)
    tcfg = cases.port_config(name, eightbit)
    jstate = jsteps.make_train_state(
        jlm.init_params(jax.random.PRNGKey(seed), jcfg), cfg=jcfg)
    tstate = bridge.from_repro(jax.device_get(jstate), device="cpu")
    jstep = jsteps.make_train_step(jcfg, **cases.KW)
    tstep = tsteps.make_train_step(tcfg, **cases.KW)
    flips = {} if eightbit else None
    for i, batch in enumerate(cases.batches(tcfg, seed=seed)):
        with jax.disable_jit():
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        cases.metrics_check(tm, jm, 1e-5, f"{name} step {i}")
        want = bridge.from_repro(jax.device_get(jstate), device="cpu")
        if eightbit:
            now = cases.code_flips(tstate, want)
            if i < cases.STEPS - 1:
                flips = cases.merge_flips(flips, now)
    assert int(tstate["step"]) == cases.STEPS
    return cases.param_check(tstate, want, 1e-5, flips)
