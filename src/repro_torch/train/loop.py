"""Restartable training loop with checkpoint/restart fault tolerance,
preemption handling and straggler detection (counterpart of
``repro/train/loop.py``).

The loop is a state machine around (state, data step): everything a
resume needs -- parameters, optimizer, step, data position -- lives in the
checkpoint, so ``run()`` after a crash or a preemption resumes where the
last committed checkpoint left off, and on the CPU bit-identically.

Straggler mitigation: each step's wall time (host clock, the step's
metrics read back, which waits for the card) is held against the median
of the last 20; a step slower than ``straggler_factor`` x that median is
reported to the supplied callback.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels import plan as plan_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.train import checkpoint


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    async_checkpoint: bool = True


class StragglerEvent(Exception):
    pass


class Trainer:
    """Trains ``cfg`` on the synthetic stream of ``data_cfg`` on
    ``device`` (the card unless the caller passes ``device="cpu"``),
    resuming from the newest committed checkpoint in
    ``loop_cfg.checkpoint_dir`` if there is one."""

    def __init__(self, cfg, loop_cfg: TrainLoopConfig, data_cfg: DataConfig,
                 *, seed: int = 0, straggler_cb: Optional[Callable] = None,
                 train_step_kwargs: Optional[dict] = None, device="cuda"):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data = SyntheticLMStream(data_cfg)
        self.seed = seed
        self.device = plan_lib.resolve_device(device)
        self.straggler_cb = straggler_cb or (lambda info: None)
        self._preempted = False
        self._ckpt_join = lambda: None
        self.train_step_kwargs = dict(train_step_kwargs or {})
        self.step_fn = steps_lib.make_train_step(cfg,
                                                 **self.train_step_kwargs)
        self.metrics_log: list = []

    # ---- fault-tolerance hooks ----
    def install_preemption_handler(self, sig=signal.SIGTERM):
        """SIGTERM (a preemption notice) -> a synchronous checkpoint at the
        next step boundary, then a clean return."""
        signal.signal(sig, lambda *_: setattr(self, "_preempted", True))

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = lm.init_params(self.cfg, gen, device=self.device)
        return steps_lib.make_train_state(
            params, self.train_step_kwargs.get("adamw_cfg"), cfg=self.cfg)

    def _resume_or_init(self):
        ckdir = Path(self.loop_cfg.checkpoint_dir)
        last = checkpoint.latest_step(ckdir)
        if last is None:
            return self._init_state(), 0
        state, manifest = checkpoint.restore(ckdir, step=last,
                                             device=self.device)
        return state, int(manifest["step"])

    def _save(self, state, step, blocking=False):
        self._ckpt_join()  # one async save in flight at a time
        self._ckpt_join = checkpoint.save(
            self.loop_cfg.checkpoint_dir, state, step=step,
            extra={"data_state": self.data.state(step),
                   "config_name": self.cfg.name},
            async_=self.loop_cfg.async_checkpoint and not blocking)
        checkpoint.garbage_collect(self.loop_cfg.checkpoint_dir,
                                   self.loop_cfg.keep_checkpoints)

    # ---- main loop ----
    def run(self):
        """Train to ``total_steps`` (or the first preemption); returns
        (state, the step reached)."""
        state, start = self._resume_or_init()
        durations: list = []
        for step in range(start, self.loop_cfg.total_steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            row = {k: float(v) for k, v in metrics.items()}  # waits
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = statistics.median(durations[-20:])
            if len(durations) > 5 and dt > self.loop_cfg.straggler_factor \
                    * med:
                self.straggler_cb({"step": step, "duration": dt,
                                   "median": med})
            if step % self.loop_cfg.log_every == 0 or \
                    step == self.loop_cfg.total_steps - 1:
                row["step"] = step
                row["s_per_step"] = dt
                self.metrics_log.append(row)
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"ce {row['ce']:.4f} gnorm {row['grad_norm']:.3f} "
                      f"({dt:.2f}s)")
            done = step + 1
            if done % self.loop_cfg.checkpoint_every == 0:
                self._save(state, done)
            if self._preempted:
                print(f"[preempted] checkpointing at step {done} and "
                      "exiting cleanly")
                self._save(state, done, blocking=True)
                self._ckpt_join()
                return state, done
        self._save(state, self.loop_cfg.total_steps, blocking=True)
        self._ckpt_join()
        return state, self.loop_cfg.total_steps
