"""Continuous-batching serving engine: chunked prefill + ragged decode
(counterpart of ``repro/serve/engine.py``, unpaged and without
speculation).

Requests wait in a bounded queue (backpressure); an admission pass moves
them into free batch slots; prompts stream through the chunked-prefill step
as [B, chunk] windows, with decode-phase slots riding along on their single
pending token; live slots then decode lockstep-free, each at its own
position.  Sampling (greedy / temperature / top-k) is per slot, from a numpy
Generator keyed on (seed, uid), so it is identical to the reference
engine's.  Both steps run the packed integer kernels on the card; the KV
cache is updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.kernels import plan as plan_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.prepare import (build_layer_plans, cache_bytes_per_slot,
                                       prepare_serving_params,
                                       serving_param_bytes)

__all__ = ["EngineConfig", "Metrics", "Request", "SamplingParams",
           "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    sampling: SamplingParams | None = None   # engine default when None
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    submit_time: float = 0.0
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0


@dataclasses.dataclass
class Metrics:
    """Engine counters: throughput split by phase, admission latency, slot
    occupancy, backpressure rejections, TTFT / TPOT samples.

    ``prefill_tokens`` counts prompt tokens consumed by chunked prefill;
    ``decode_tokens`` only tokens sampled in pure decode passes, so
    decode_tok_s divides tokens by the wall time of the same passes.
    """
    prefill_tokens: int = 0
    generated_tokens: int = 0
    decode_tokens: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    decode_passes: int = 0
    admitted: int = 0
    retired: int = 0
    rejected: int = 0
    steps: int = 0
    slot_steps_live: int = 0
    slot_steps_total: int = 0
    admission_wait_s: float = 0.0
    ttft_s: list = dataclasses.field(default_factory=list)
    tpot_s: list = dataclasses.field(default_factory=list)

    @staticmethod
    def _dist(samples) -> dict:
        if not samples:
            return {"mean": 0.0, "p50": 0.0, "p95": 0.0}
        arr = np.asarray(samples, np.float64)
        return {"mean": float(arr.mean()),
                "p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95))}

    def report(self) -> dict:
        def div(a, b):
            return a / b if b else 0.0
        return {
            "prefill_tokens": self.prefill_tokens,
            "generated_tokens": self.generated_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_tok_s": div(self.prefill_tokens, self.prefill_time_s),
            "decode_tok_s": div(self.decode_tokens, self.decode_time_s),
            "decode_step_ms": 1e3 * div(self.decode_time_s,
                                        self.decode_passes),
            "admitted": self.admitted,
            "retired": self.retired,
            "rejected": self.rejected,
            "steps": self.steps,
            "occupancy": div(self.slot_steps_live, self.slot_steps_total),
            "mean_admission_wait_s": div(self.admission_wait_s,
                                         self.admitted),
            "ttft_s": self._dist(self.ttft_s),
            "tpot_s": self._dist(self.tpot_s),
        }


def _probs_for(logits_row, sp: SamplingParams) -> np.ndarray:
    """Temperature / top-k transform of one logits row, in float64 on the
    host (the reference engine's transform, so draws match it)."""
    scaled = np.asarray(logits_row, np.float64) / max(sp.temperature, 1e-6)
    if sp.top_k > 0:
        kk = min(sp.top_k, scaled.size)
        kth = np.partition(scaled, -kk)[-kk]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    scaled = scaled - scaled.max()
    probs = np.exp(scaled)
    probs /= probs.sum()
    return probs


def sample_token(logits_row, sp: SamplingParams, rng) -> int:
    """Sample one token (greedy / temperature / top-k) with the slot's
    numpy Generator."""
    if sp.greedy:
        return int(np.argmax(np.asarray(logits_row, np.float64)))
    probs = _probs_for(logits_row, sp)
    return int(rng.choice(len(probs), p=probs))


class ServingEngine:
    """Admission scheduler over chunked prefill + ragged decode.

    ``params`` is a float parameter tree (reference layout, e.g. from
    ``lm.init_params`` or ``bridge.from_repro``); the engine packs it for
    ``device`` itself.  ``backend`` selects the kernels ('auto': the CUDA
    kernels on the card, the plain versions on the CPU)."""

    def __init__(self, cfg, params, *, config: EngineConfig | None = None,
                 device="cuda", backend: str = "auto", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is still to be ported (ROADMAP.md Queue 1 "
                "item 14)")
        lm.check_supported(cfg)
        self.device = plan_lib.resolve_device(device)
        config = config if config is not None else EngineConfig()
        self.config = config
        self.cfg = cfg
        self.cache_bytes_per_slot = cache_bytes_per_slot(cfg, config.max_len)
        self.hbm_cache_budget = config.hbm_cache_budget
        max_batch = config.slots_for(self.cache_bytes_per_slot)
        self.max_batch = max_batch
        self.max_len = config.max_len
        self.prefill_chunk = config.prefill_chunk
        self.max_queue = config.max_queue
        self.sampling = config.sampling
        run_cfg = cfg if config.packed else cfg.replace(
            quant=cfg.quant.replace(enabled=False))
        self.params = prepare_serving_params(params, run_cfg,
                                             device=self.device)
        # one execution plan per layer, fixed before serving, for both row
        # counts the steps use (decode batch, prefill batch x chunk); the
        # planners are memoized, so the steps' packed ops dispatch through
        # these same objects (plan_report lists them)
        self.plans = build_layer_plans(
            self.params, run_cfg, batch_rows=max_batch,
            prefill_rows=max_batch * self.prefill_chunk, backend=backend)
        self._decode = steps_lib.make_decode_step(run_cfg, backend=backend)
        self._prefill = steps_lib.make_prefill_chunk_step(run_cfg,
                                                          backend=backend)
        self._queue: deque[Request] = deque()
        self.caches = lm.init_caches(cfg, max_batch, self.max_len,
                                     dtype=torch.bfloat16, device=self.device)
        self.slot_req: list = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)   # tokens in cache
        self.slot_fed = np.zeros(max_batch, np.int32)   # prompt consumed
        self._slot_rng: list = [None] * max_batch
        self._finished: list = []
        self.metrics = Metrics()

    # ------------------------------------------------------------------
    # Submission / admission
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request.  Returns False (rejected, counted in metrics)
        when the backpressure cap ``max_queue`` is hit."""
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds engine "
                f"max_len ({self.max_len})")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.metrics.rejected += 1
            return False
        if not req.submit_time:
            req.submit_time = time.perf_counter()
        self._queue.append(req)
        return True

    def _admit(self):
        now = time.perf_counter()
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self._queue:
                req = self._queue.popleft()
                # attention rows need no reset: validity is re-derived per
                # call from the slot offsets, so stale rows stay masked
                self.slot_req[slot] = req
                self.slot_pos[slot] = 0
                self.slot_fed[slot] = 0
                sp = req.sampling or self.sampling
                self._slot_rng[slot] = np.random.default_rng(
                    (sp.seed, req.uid & 0xFFFFFFFF))
                req.admit_time = now
                self.metrics.admitted += 1
                self.metrics.admission_wait_s += now - req.submit_time

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: admit, then one batched model pass --
        chunked prefill while any slot is mid-prompt (decode-phase slots
        ride along), else a single-token ragged decode."""
        self._admit()
        live = [s for s in range(self.max_batch)
                if self.slot_req[s] is not None]
        if not live:
            return False
        self.metrics.steps += 1
        self.metrics.slot_steps_live += len(live)
        self.metrics.slot_steps_total += self.max_batch
        prefilling = any(
            self.slot_fed[s] < len(self.slot_req[s].prompt) for s in live)
        t0 = time.perf_counter()
        if prefilling:
            n_prompt = self._prefill_pass(live)
            self.metrics.prefill_time_s += time.perf_counter() - t0
            self.metrics.prefill_tokens += n_prompt
        else:
            self._decode_pass(live)
            self.metrics.decode_time_s += time.perf_counter() - t0
            self.metrics.decode_passes += 1
        return True

    def _prefill_pass(self, live) -> int:
        c = self.prefill_chunk
        tokens = np.zeros((self.max_batch, c), np.int32)
        index = np.zeros(self.max_batch, np.int32)
        valid = np.zeros(self.max_batch, np.int32)
        take = {}
        n_prompt = 0
        for s in live:
            req = self.slot_req[s]
            index[s] = self.slot_pos[s]
            rem = len(req.prompt) - int(self.slot_fed[s])
            if rem > 0:        # mid-prompt: its next chunk window
                t = min(c, rem)
                fed = int(self.slot_fed[s])
                tokens[s, :t] = req.prompt[fed:fed + t]
                valid[s] = take[s] = t
                n_prompt += t
            else:              # decode-phase rider: one pending token
                tokens[s, 0] = req.output[-1]
                valid[s] = 1
        logits, self.caches = self._prefill(
            self.params, self.caches, {"tokens": tokens}, index, valid)
        logits = logits.float().cpu().numpy()
        for s in live:
            req = self.slot_req[s]
            if s in take:
                self.slot_fed[s] += take[s]
                self.slot_pos[s] += take[s]
                if self.slot_fed[s] == len(req.prompt):
                    self._emit_token(s, logits[s], decode_pass=False)
            else:
                self.slot_pos[s] += 1
                self._emit_token(s, logits[s], decode_pass=False)
        return n_prompt

    def _decode_pass(self, live):
        tokens = np.zeros((self.max_batch, 1), np.int32)
        index = np.zeros(self.max_batch, np.int32)
        valid = np.zeros(self.max_batch, np.int32)
        for s in live:
            req = self.slot_req[s]
            tokens[s, 0] = req.output[-1] if req.output \
                else int(req.prompt[-1])
            index[s] = self.slot_pos[s]
            valid[s] = 1
        logits, self.caches = self._decode(
            self.params, self.caches, {"tokens": tokens}, index, valid)
        logits = logits.float().cpu().numpy()
        for s in live:
            self.slot_pos[s] += 1
            self._emit_token(s, logits[s], decode_pass=True)

    def _emit_token(self, s: int, logits_row: np.ndarray, *,
                    decode_pass: bool):
        """Sample one token for slot ``s``, stamp TTFT/TPOT, and retire the
        request when it reaches max_new_tokens."""
        req = self.slot_req[s]
        tok = sample_token(logits_row, req.sampling or self.sampling,
                           self._slot_rng[s])
        req.output.append(int(tok))
        self.metrics.generated_tokens += 1
        if decode_pass:
            self.metrics.decode_tokens += 1
        if len(req.output) == 1:
            req.first_token_time = time.perf_counter()
            self.metrics.ttft_s.append(req.first_token_time
                                       - req.submit_time)
        if len(req.output) >= req.max_new_tokens:
            req.done = True
            req.finish_time = time.perf_counter()
            if len(req.output) > 1:
                self.metrics.tpot_s.append(
                    (req.finish_time - req.first_token_time)
                    / (len(req.output) - 1))
            self._finished.append(req)
            self.metrics.retired += 1
            self.slot_req[s] = None

    # ------------------------------------------------------------------
    # Reporting / draining
    # ------------------------------------------------------------------

    def take_finished(self) -> list:
        """Hand over every request retired since the last call."""
        done, self._finished = self._finished, []
        return done

    def plan_report(self):
        """Flat per-layer plan rows (path + KernelPlan.describe())."""
        return [{"layer": path, **plan.describe()}
                for path, plan in sorted(self.plans.items())]

    def capacity_report(self) -> dict:
        """Cache-capacity accounting: bytes per slot, admitted slots, and
        the packed parameter bytes on the device."""
        return {
            "kv_bits": self.cfg.quant.kv_bits or 16,
            "cache_bytes_per_slot": self.cache_bytes_per_slot,
            "cache_bytes": self.cache_bytes_per_slot * self.max_batch,
            "hbm_cache_budget": self.hbm_cache_budget,
            "slots": self.max_batch,
            "param_bytes": serving_param_bytes(self.params),
            "paged": False,
        }

    def run_to_completion(self):
        """Drain queue + slots; returns every request retired since the
        last call."""
        while self.step():
            pass
        return self.take_finished()
