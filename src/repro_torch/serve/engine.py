"""Continuous-batching serving engine: chunked prefill + ragged decode,
and speculative decoding (counterpart of ``repro/serve/engine.py``).

Requests wait in a bounded queue (backpressure); an admission pass moves
them into free batch slots; prompts stream through the chunked-prefill step
as [B, chunk] windows, with decode-phase slots riding along on their single
pending token; live slots then decode lockstep-free, each at its own
position.  Sampling (greedy / temperature / top-k) is per slot, from a numpy
Generator keyed on (seed, uid), so it is identical to the reference
engine's.  Both steps run the packed integer kernels on the card, each
replayed as a CUDA graph captured at construction over static buffers
(``launch/steps.graphed_serving_steps``, the counterpart of the
reference's ``jitted_serving_steps``); the KV cache is updated in place.

With ``EngineConfig(paged=True)`` the slot-contiguous KV cache becomes a
refcounted page pool behind per-slot block tables (serve/pages.py):
admission reserves pages instead of max_len slots, prompt prefixes are
shared through a radix index with copy-on-write on divergence, and
retirement frees pages -- the cache budget then bounds *physical* pages
while ``max_batch`` bounds *logical* slots.  Every paged read goes through
the paged flash-decoding kernel (K4).

With ``EngineConfig(speculative_k=k)`` a :class:`~repro_torch.serve.
speculative.DraftModel` re-packs the same checkpoint at ``draft_w_bits``
with its own caches (paged: its own pool), and every pure-decode pass
becomes a speculative cycle: one draft step proposes up to k tokens a
slot, one [B, k+1] verify window of the target scores them, and the
rejection rule commits 1 .. k+1 tokens a slot (``_speculative_pass``).
All five steps (target decode, prefill and verify; draft prefill and
draft) are CUDA graphs on the card, sharing one split-K workspace.

With ``mesh`` (a one-row launch/mesh.ServingMesh) the engine serves
tensor-parallel: a serve/shard.ShardPlan splits the packed weights'
columns, the caches' kv heads and the recurrent states' channels over
the row's devices, each shard launching its own kernels at its own
shapes (a speculative engine's draft is split the same way); the token
stream is the single-device engine's.  The accessors ``num_pending``,
``num_live``, ``take_queued`` and ``take_finished`` are what
serve/router.Router reads.
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
from repro_torch.parallel import sharding
from repro_torch.serve import pages as pages_lib
from repro_torch.serve import speculative as speculative_lib
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.prepare import (build_layer_plans, cache_bytes_per_slot,
                                       cache_page_bytes,
                                       prepare_serving_params,
                                       serving_param_bytes)
from repro_torch.serve.shard import ShardPlan

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

    Speculative decoding adds ``drafted_tokens`` (draft proposals
    considered: each slot's ``limit``, not k x cycles), ``accepted_tokens``
    (those the rejection rule kept), ``verify_tokens`` (window rows
    scored) and ``spec_cycles`` (draft + verify pairs);
    ``acceptance_rate`` = accepted / drafted.  A cycle's committed tokens
    count as ``decode_tokens`` and the cycle as a decode pass, so
    ``decode_tok_s`` compares with a plain engine's and ``decode_step_ms``
    is the wall time of a cycle.
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
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    verify_tokens: int = 0
    spec_cycles: int = 0
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
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "verify_tokens": self.verify_tokens,
            "spec_cycles": self.spec_cycles,
            "acceptance_rate": div(self.accepted_tokens,
                                   self.drafted_tokens),
            "ttft_s": self._dist(self.ttft_s),
            "tpot_s": self._dist(self.tpot_s),
        }


class ServingEngine:
    """Admission scheduler over chunked prefill + ragged decode.

    ``params`` is a float parameter tree (reference layout, e.g. from
    ``lm.init_params`` or ``bridge.from_repro``); the engine packs it for
    ``device`` itself.  ``backend`` selects the kernels ('auto': the CUDA
    kernels on the card, the plain versions on the CPU).  ``mesh``, a
    one-row ('data', 'model') serving mesh, makes the engine
    tensor-parallel over the row's devices and takes the place of
    ``device`` (the row's first device is home)."""

    def __init__(self, cfg, params, *, config: EngineConfig | None = None,
                 device="cuda", backend: str = "auto", mesh=None):
        config = config if config is not None else EngineConfig()
        if config.paged and cfg.sliding_window:
            raise ValueError(
                "paged KV cache and the sliding-window ring layout do not "
                "compose; use paged=False for sliding-window configs")
        if config.speculative_k:
            self._validate_speculative(cfg)
        lm.check_supported(cfg)
        # tensor-parallel serving: with a one-row ('data', 'model') mesh a
        # ShardPlan splits the packed weights' columns, the caches' kv
        # heads and the recurrent states' channels over the row's devices
        # (serve/shard.py), the draft's too; the engine runs on the row's
        # first device, where every whole leaf lives.  A mesh of one shard
        # is the single-device engine.
        self.shard_plan = None
        if mesh is not None:
            if mesh.shape["data"] != 1:
                raise ValueError(
                    f"an engine serves one replica: its mesh has "
                    f"{mesh.shape['data']} data rows (serve/router.Router "
                    f"serves one engine a row)")
            self.shard_plan = ShardPlan(mesh)
            device = self.shard_plan.devices[0]
        self.device = plan_lib.resolve_device(device)
        self.config = config
        self.cfg = cfg
        kv_bits = cfg.quant.kv_bits
        self.paged = config.paged
        self.page_size = config.page_size
        # a slot's bytes: max_len rows, or a sliding-window config's ring
        self.cache_bytes_per_slot = cache_bytes_per_slot(cfg, config.max_len)
        self.hbm_cache_budget = config.hbm_cache_budget
        if self.paged:
            # the budget buys pool pages; logical slots are bounded only by
            # max_batch, and each admission reserves the pages its request
            # can write
            pages_lib.validate_page_size(self.page_size, kv_bits)
            self.page_bytes = cache_page_bytes(cfg, self.page_size)
            if self.page_bytes == 0:
                raise ValueError(
                    "paged=True requires at least one attention layer "
                    "(nothing pageable in an attention-free stack)")
            self.pages_per_slot = -(-config.max_len // self.page_size)
            self.num_pages = config.pages_for(self.page_bytes,
                                              self.pages_per_slot)
            # admission-time estimate: what one worst-case (no-sharing,
            # full-extent) request would pin
            self.cache_bytes_per_slot = self.pages_per_slot * self.page_bytes
            max_batch = config.max_batch
            # a shared prefix's pages reconstruct every layer's state only
            # in a pure-attention decoder stack: recurrent layers carry
            # unpaged per-slot state, and cross-attention keys off the
            # encoder's output, not the prompt, so their prompts are never
            # skipped
            self._share = (config.prefix_sharing
                           and not cfg.is_encoder_decoder
                           and all(cfg.layer_kind(i) == "attn"
                                   for i in range(cfg.num_layers)))
        else:
            max_batch = config.slots_for(self.cache_bytes_per_slot)
        self.max_batch = max_batch
        self.max_len = config.max_len
        self.prefill_chunk = config.prefill_chunk
        if cfg.sliding_window:
            # ring caches admit only token-by-token prefill: a wider window
            # would overwrite ring slots still visible to earlier queries
            # of the same window (attention refuses that case)
            self.prefill_chunk = 1
        self.max_queue = config.max_queue
        self.sampling = config.sampling
        run_cfg = cfg if config.packed else cfg.replace(
            quant=cfg.quant.replace(enabled=False))
        self.params = prepare_serving_params(
            params, run_cfg, dense_store=config.dense_store,
            device=self.device)
        if self.shard_plan is not None:
            self.params = self.shard_plan.place_params(self.params)
        # one execution plan per layer, fixed before serving, for both row
        # counts the steps use (decode batch, prefill batch x chunk); the
        # planners are memoized, so the steps' packed ops dispatch through
        # these same objects (plan_report lists them).  autotune=True
        # warm-tunes the missing signatures first, so the graphs captured
        # below, and the split-K workspace sized while they warm up, see
        # the tuned geometry.
        self.plans = build_layer_plans(
            self.params, run_cfg, batch_rows=max_batch,
            prefill_rows=max_batch * self.prefill_chunk, backend=backend,
            autotune=config.autotune, shard_plan=self.shard_plan)
        self._queue: deque[Request] = deque()
        if self.paged:
            self.caches = lm.init_caches(
                cfg, max_batch, self.max_len, dtype=torch.bfloat16,
                page_size=self.page_size, num_pages=self.num_pages,
                device=self.device)
            self.pool = pages_lib.PagePool(self.num_pages, self.page_size,
                                           kv_bits)
            self.block_tables = np.zeros((max_batch, self.pages_per_slot),
                                         np.int32)
            self._slot_extent = [0] * max_batch   # table entries in use
            self._slot_spare: list = [[] for _ in range(max_batch)]
            self.peak_live_slots = 0
        else:
            self.caches = lm.init_caches(cfg, max_batch, self.max_len,
                                         dtype=torch.bfloat16,
                                         device=self.device)
        if self.shard_plan is not None:
            self.caches = self.shard_plan.place_caches(self.caches)
        # batch-1 fresh states, one a recurrent kind: admission copies
        # them into the slot's rows (mLSTM's and sLSTM's m start at -1e30)
        kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
        self._fresh = {kind: lm.init_recurrent_cache(cfg, kind, 1,
                                                     self.device)
                       for kind in kinds - {"attn"}}
        if self.shard_plan is not None:
            # split as the caches are: each shard resets its own channels
            self._fresh = self.shard_plan.place_caches(self._fresh)
        # speculative decoding: the draft model (the same checkpoint
        # re-packed at draft_w_bits, its own caches and, paged, its own
        # pool); pure-decode passes become draft + verify cycles
        self.spec = None
        self._verify = None
        if config.speculative_k:
            self.spec = speculative_lib.DraftModel(
                cfg, params, config, max_batch=max_batch,
                max_len=self.max_len, device=self.device,
                target_params=self.params, backend=backend,
                shard_plan=self.shard_plan)
        # the steps over static buffers, bound to these params and caches
        # (which stay at their addresses: copy-on-write, copy_page and
        # import_paged_state write into them in place); on the card they
        # are warmed up and captured as CUDA graphs here
        t0 = time.perf_counter()
        bt_width = self.pages_per_slot if self.paged else None
        # one CUDA graph cannot span cards: shards on distinct devices step
        # eagerly (capacity_report's step_graphs says so)
        capture = self.shard_plan is None \
            or len(set(self.shard_plan.devices)) == 1
        if self.spec is None:
            self._decode, self._prefill = steps_lib.graphed_serving_steps(
                run_cfg, self.params, self.caches, batch=max_batch,
                prefill_chunk=self.prefill_chunk,
                block_table_width=bt_width, backend=backend,
                capture=capture)
        else:
            st = steps_lib.graphed_speculative_steps(
                run_cfg, self.params, self.caches, self.spec.run_cfg,
                self.spec.params, self.spec.caches, k=config.speculative_k,
                batch=max_batch, prefill_chunk=self.prefill_chunk,
                block_table_width=bt_width,
                draft_block_table_width=self.spec.pages_per_slot,
                backend=backend, capture=capture)
            self._decode, self._prefill = st["decode"], st["prefill_chunk"]
            self._verify = st["verify"]
            self.spec.prefill_step = st["draft_prefill"]
            self.spec.draft_step = st["draft"]
        self.step_setup_s = time.perf_counter() - t0
        self.slot_req: list = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)   # tokens in cache
        self.slot_fed = np.zeros(max_batch, np.int32)   # prompt consumed
        self._slot_rng: list = [None] * max_batch
        self._finished: list = []
        self.metrics = Metrics()

    @staticmethod
    def _validate_speculative(cfg):
        """Speculation needs a pure-attention decoder whose chunked writes
        equal sequential writes: the verify window's rollback does not
        hold for ring caches, recurrent state, or position schemes the
        draft step does not model."""
        problems = []
        if cfg.is_encoder_decoder:
            problems.append("encoder-decoder stacks")
        if cfg.sliding_window:
            problems.append("sliding-window (ring) KV caches")
        if cfg.mrope:
            problems.append("M-RoPE position ids")
        if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
            problems.append("non-attention (recurrent) layers")
        if problems:
            raise ValueError(
                f"speculative_k > 0 requires a pure-attention decoder "
                f"stack; this config has: {', '.join(problems)}")

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

    def _reset_slot(self, slot: int):
        """Restore the slot's rows of every recurrent state to the fresh
        values, in place (the steps' graphs hold the cache pointers; a
        channel-split state's shards each write their slice).
        Attention rows need no reset: validity is re-derived per call from
        the slot offsets, so stale rows stay masked until overwritten.  An
        encoder-decoder's ``cross_kv`` (None: the engine serves it
        decoder-only, as the reference's does) is not a recurrent kind and
        is left alone."""
        for layer in self.caches:
            for kind, sub in layer.items():
                if kind in self._fresh:
                    for name, buf in sub.items():
                        # a channel-split state: each shard its own slice
                        for dst, src in zip(
                                sharding.parts(buf),
                                sharding.parts(self._fresh[kind][name])):
                            dst[slot:slot + 1].copy_(src)

    # -- paged reservation / copy-on-write -----------------------------

    def _reserve_pages(self, slot: int, req: Request) -> int | None:
        """Reserve every page ``req`` can write, all-or-nothing.

        Positions written span ``[0, W)`` with ``W = len(prompt) +
        max_new_tokens - 1`` (the last sampled token is returned, never
        cached).  A cached prefix match (capped at ``len(prompt) - 1``, so
        the last prompt token's logits are always computed) contributes
        shared pages -- retained, not copied; fresh pages cover the rest,
        plus copy-on-write spares for the two divergence writes a request
        can hit: its first write into a partially shared page, and its
        first generated token landing in the prompt's registered tail
        page.  Returns the shared token count, or None (nothing taken)
        when the pool cannot cover it -- the request stays queued."""
        ps = self.page_size
        n_prompt = len(req.prompt)
        written = n_prompt + req.max_new_tokens - 1
        n_shared, shared = 0, []
        if self._share:
            n_shared, shared = self.pool.match_prefix(
                req.prompt, max_tokens=n_prompt - 1)
        first_partial = 1 if n_shared % ps else 0
        fill_from = n_shared // ps + first_partial
        fresh = -(-written // ps) - fill_from
        tail_cow = 1 if (self._share and n_prompt % ps
                         and written > n_prompt) else 0
        for pg, _rows in shared:             # pin before alloc can evict
            self.pool.retain(pg)
        got = self.pool.alloc(fresh + first_partial + tail_cow)
        if got is None:
            for pg, _rows in shared:
                self.pool.release(pg)
            return None
        table = self.block_tables[slot]
        table[:] = 0
        for i, (pg, _rows) in enumerate(shared):
            table[i] = pg
        table[fill_from:fill_from + fresh] = got[:fresh]
        self._slot_extent[slot] = fill_from + fresh
        self._slot_spare[slot] = got[fresh:]
        if n_shared:
            self.pool.prefix_hits += 1
            self.pool.prefix_hit_tokens += n_shared
        return n_shared

    def _release_slot_pages(self, slot: int):
        for p in self.block_tables[slot][:self._slot_extent[slot]]:
            self.pool.release(int(p))
        for p in self._slot_spare[slot]:
            self.pool.release(int(p))
        self.block_tables[slot][:] = 0
        self._slot_extent[slot] = 0
        self._slot_spare[slot] = []

    def _ensure_writable(self, slot: int, lo: int, hi: int):
        """Copy-on-write ahead of a pass writing positions ``[lo, hi)``:
        any mapped page that is shared (ref > 1) or frozen by the prefix
        index gets a private copy first (reserved spare, else a fresh
        alloc under pressure), so writers never touch shared bytes."""
        ps = self.page_size
        table = self.block_tables[slot]
        for pi in range(lo // ps, -(-hi // ps)):
            pg = int(table[pi])
            if not (self.pool.is_shared(pg) or self.pool.is_immutable(pg)):
                continue
            spare = self._slot_spare[slot]
            if spare:
                dst = spare.pop()
            else:
                got = self.pool.alloc(1)
                if got is None:
                    raise RuntimeError(
                        f"page pool exhausted during copy-on-write for "
                        f"slot {slot} (page {pg}); reservation math must "
                        f"cover every divergence write")
                dst = got[0]
            pages_lib.copy_page(self.caches, pg, dst)
            table[pi] = dst
            self.pool.release(pg)
            self.pool.cow_copies += 1

    def _register_prompt(self, s: int, req: Request):
        """Hash-cons the just-completed prompt's pages into the prefix
        index (before the first generated token, which may retire the
        slot at max_new_tokens=1): later requests with the same prefix
        share these physical pages instead of prefilling them again."""
        n_pages = -(-len(req.prompt) // self.page_size)
        self.pool.register_prefix(
            req.prompt, [int(p) for p in self.block_tables[s][:n_pages]])

    def _admit(self):
        now = time.perf_counter()
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self._queue:
                req = self._queue[0]
                n_shared = 0
                if self.paged:
                    n_shared = self._reserve_pages(slot, req)
                    if n_shared is None:
                        # head-of-line blocks until pages free: FIFO, no
                        # starvation of large requests by small ones
                        break
                self._queue.popleft()
                self._reset_slot(slot)
                self.slot_req[slot] = req
                self.slot_pos[slot] = n_shared
                self.slot_fed[slot] = n_shared
                if self.spec is not None:
                    # the draft replays the FULL prompt (no prefix skip:
                    # its cache has no rows for skipped positions)
                    self.spec.begin_slot(slot, req)
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
        if self.paged:
            self.peak_live_slots = max(self.peak_live_slots, len(live))
        prefilling = any(
            self.slot_fed[s] < len(self.slot_req[s].prompt) for s in live)
        if self.spec is not None:
            # the draft may still be replaying a prefix-skipped prompt
            # after the target finished: keep the pass a prefill pass
            # (speculation runs on pure-decode passes only)
            prefilling = prefilling or any(
                not self.spec.prompt_done(s, self.slot_req[s])
                for s in live)
        t0 = time.perf_counter()
        if prefilling:
            n_prompt = self._prefill_pass(live)
            self.metrics.prefill_time_s += time.perf_counter() - t0
            self.metrics.prefill_tokens += n_prompt
        else:
            if self.spec is not None:
                self._speculative_pass(live)
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
            elif req.output:   # decode-phase rider: one pending token
                tokens[s, 0] = req.output[-1]
                valid[s] = 1
            # else: the target's prompt is done but its first token is
            # stashed until the draft finishes its full-prompt replay --
            # a dead slot (valid 0) in this target pass
        step_args = ()
        if self.paged:
            for s in live:
                lo = int(index[s])
                self._ensure_writable(s, lo, lo + int(valid[s]))
            step_args = (self.block_tables,)
        logits = None
        if int(valid.sum()):   # all-stash-waiting passes skip the launch
            logits, self.caches = self._prefill(
                self.params, self.caches, {"tokens": tokens}, index, valid,
                *step_args)
            logits = logits.float().cpu().numpy()
        if self.spec is not None:
            self._draft_prefill(live)
        for s in live:
            req = self.slot_req[s]
            if s in take:
                self.slot_fed[s] += take[s]
                self.slot_pos[s] += take[s]
                if self.slot_fed[s] == len(req.prompt):
                    if self.paged and self._share:
                        self._register_prompt(s, req)
                    if self.spec is None or self.spec.prompt_done(s, req):
                        self._emit_token(s, logits[s], decode_pass=False)
                    else:
                        # prefix sharing let the target finish before the
                        # draft's full replay: park the first-token logits
                        self.spec.stash(s, logits[s])
            elif req.output:
                self.slot_pos[s] += 1
                self._emit_token(s, logits[s], decode_pass=False)
            elif self.spec is not None and self.spec.has_stash(s) \
                    and self.spec.prompt_done(s, req):
                # the draft just caught up: emit the parked first token
                self._emit_token(s, self.spec.pop_stash(s),
                                 decode_pass=False)
        return n_prompt

    def _draft_prefill(self, live):
        """Feed the draft cache its own prefill window: prompt chunks for
        slots still replaying (from the draft's position ``fed``: the
        draft never prefix-skips), and the pending token of decode riders,
        so that the draft's and the target's caches stay aligned through
        mixed passes."""
        spec = self.spec
        c = self.prefill_chunk
        tokens = np.zeros((self.max_batch, c), np.int32)
        index = np.zeros(self.max_batch, np.int32)
        valid = np.zeros(self.max_batch, np.int32)
        fed_take = {}
        for s in live:
            req = self.slot_req[s]
            fed = int(spec.fed[s])
            rem = len(req.prompt) - fed
            if rem > 0:
                t = min(c, rem)
                tokens[s, :t] = req.prompt[fed:fed + t]
                index[s] = fed
                valid[s] = fed_take[s] = t
            elif req.output:
                tokens[s, 0] = req.output[-1]
                index[s] = self.slot_pos[s]
                valid[s] = 1
        if not int(valid.sum()):
            return
        step_args = (spec.block_tables,) if spec.paged else ()
        _, spec.caches = spec.prefill_step(
            spec.params, spec.caches, {"tokens": tokens}, index, valid,
            *step_args)
        for s, t in fed_take.items():
            spec.fed[s] += t

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
        step_args = ()
        if self.paged:
            for s in live:
                self._ensure_writable(s, int(index[s]), int(index[s]) + 1)
            step_args = (self.block_tables,)
        logits, self.caches = self._decode(
            self.params, self.caches, {"tokens": tokens}, index, valid,
            *step_args)
        logits = logits.float().cpu().numpy()
        for s in live:
            self.slot_pos[s] += 1
            self._emit_token(s, logits[s], decode_pass=True)

    def _speculative_pass(self, live):
        """One speculative cycle: the draft step proposes up to ``k``
        greedy tokens a slot, one [B, k+1] verify window of the target
        scores the chain, and the rejection rule
        (speculative.accept_tokens) commits the longest target-faithful
        prefix a slot -- 1 .. k+1 tokens for two graph replays."""
        k = self.config.speculative_k
        spec = self.spec
        tokens = np.zeros((self.max_batch, 1), np.int32)
        index = np.zeros(self.max_batch, np.int32)
        # dead slots draft at limit -1: limit + 1 = 0 gates off every cache
        # write (a dead row's all-zero block table would alias page 0)
        limit = np.full(self.max_batch, -1, np.int32)
        for s in live:
            req = self.slot_req[s]
            tokens[s, 0] = req.output[-1] if req.output \
                else int(req.prompt[-1])
            index[s] = self.slot_pos[s]
            # a cycle commits at most limit + 1 tokens, so limit =
            # min(k, remaining - 1) never drafts past the request's budget
            # and every cache write stays inside the reserved extent
            limit[s] = min(k, req.max_new_tokens - len(req.output) - 1)
        d_args = (spec.block_tables,) if spec.paged else ()
        drafted, spec.caches = spec.draft_step(
            spec.params, spec.caches, {"tokens": tokens}, index, limit,
            *d_args)
        drafted = drafted.cpu().numpy()                    # [B, k]
        win = np.zeros((self.max_batch, k + 1), np.int32)  # [t0, d_0 ..]
        win[:, 0] = tokens[:, 0]
        win[:, 1:] = drafted
        valid = np.maximum(limit + 1, 0).astype(np.int32)
        v_args = ()
        if self.paged:
            for s in live:
                lo = int(index[s])
                self._ensure_writable(s, lo, lo + int(valid[s]))
            v_args = (self.block_tables,)
        logits, self.caches = self._verify(
            self.params, self.caches, {"tokens": win}, index, valid,
            *v_args)
        logits = logits.float().cpu().numpy()              # [B, k+1, V]
        self.metrics.spec_cycles += 1
        for s in live:
            req = self.slot_req[s]
            lim = int(limit[s])
            committed = speculative_lib.accept_tokens(
                logits[s, :lim + 1], drafted[s, :lim],
                req.sampling or self.sampling, self._slot_rng[s])
            self.metrics.drafted_tokens += lim
            self.metrics.accepted_tokens += len(committed) - 1
            self.metrics.verify_tokens += lim + 1
            for tok in committed:
                self.slot_pos[s] += 1
                self._commit_token(s, int(tok), decode_pass=True)
                if self.slot_req[s] is None:   # retired mid-window
                    break

    def _emit_token(self, s: int, logits_row: np.ndarray, *,
                    decode_pass: bool):
        """Sample one token from a logits row and commit it: the plain
        emission path.  It samples through speculative.sample_token, the
        primitive of the speculative bonus / resample too, so both draw
        from the same per-slot distributions and generator streams."""
        req = self.slot_req[s]
        tok = speculative_lib.sample_token(
            logits_row, req.sampling or self.sampling, self._slot_rng[s])
        self._commit_token(s, tok, decode_pass=decode_pass)

    def _commit_token(self, s: int, tok: int, *, decode_pass: bool):
        """Append one chosen token to slot ``s``'s request: metrics,
        TTFT/TPOT stamps, and retirement (slot, pages and the draft's
        pages released) when the request reaches max_new_tokens."""
        req = self.slot_req[s]
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
            if self.paged:
                # page-level retirement: drop this slot's references only;
                # prefix-index pages keep their index ref and stay cached
                self._release_slot_pages(s)
            if self.spec is not None:
                self.spec.release_slot(s)

    # ------------------------------------------------------------------
    # Reporting / draining
    # ------------------------------------------------------------------

    @property
    def num_pending(self) -> int:
        return len(self._queue)

    @property
    def num_live(self) -> int:
        """Occupied batch slots (the Router's load term, with the queue)."""
        return sum(r is not None for r in self.slot_req)

    def take_finished(self) -> list:
        """Hand over every request retired since the last call (the Router
        collects after each fleet tick)."""
        done, self._finished = self._finished, []
        return done

    def take_queued(self) -> list:
        """Hand over the admission queue without serving it: a draining
        replica's waiting requests, which the Router re-places while this
        engine's live slots retire."""
        queued, self._queue = list(self._queue), deque()
        return queued

    def plan_report(self):
        """Flat per-layer plan rows (path + KernelPlan.describe(), whose
        ``source`` says 'heuristic' or 'tuned')."""
        return [{"layer": path, **plan.describe()}
                for path, plan in sorted(self.plans.items())]

    def capacity_report(self) -> dict:
        """Cache-capacity accounting: bytes per slot, admitted slots, the
        cache and packed parameter bytes on the device (the dense store's
        words when ``dense_store``); paged engines add the pool's
        physical-vs-logical page counters (free / live / shared pages,
        prefix-hit, COW and eviction counts); speculative engines a
        ``speculative`` section (the draft's precision, param bytes and
        pool); tensor-parallel engines a ``shard_plan`` section (the param
        bytes by shard and, with recurrent layers, a slot's state bytes by
        shard beside the one-shard figure)."""
        rep = {
            "kv_bits": self.cfg.quant.kv_bits or 16,
            "cache_bytes_per_slot": self.cache_bytes_per_slot,
            "cache_bytes": (self.num_pages * self.page_bytes if self.paged
                            else self.cache_bytes_per_slot * self.max_batch),
            "hbm_cache_budget": self.hbm_cache_budget,
            "slots": self.max_batch,
            "param_bytes": serving_param_bytes(self.params),
            "paged": self.paged,
            "dense_store": self.config.dense_store,
            # the steps' warm-up and CUDA-graph capture at __init__ (host
            # clock; on the CPU only the static buffers are made)
            "step_graphs": self._decode.graph is not None,
            "step_setup_s": self.step_setup_s,
        }
        if self.paged:
            rep.update(
                page_size=self.page_size,
                page_bytes=self.page_bytes,
                num_pages=self.num_pages,
                pages_per_slot=self.pages_per_slot,
                # what worst-case reservations alone would fit; sharing
                # lifts live slots above this
                guaranteed_slots=self.num_pages // self.pages_per_slot,
                peak_live_slot_count=self.peak_live_slots,
                prefix_sharing=self._share,
                **self.pool.report())
        if self.spec is not None:
            rep["speculative"] = self.spec.describe()
        if self.shard_plan is not None:
            rep["shard_plan"] = {
                **self.shard_plan.describe(),
                "param_bytes": self.shard_plan.shard_param_bytes(
                    self.params)}
            if self._fresh:
                rep["shard_plan"]["recurrent_bytes_per_slot"] = \
                    self.shard_plan.shard_state_bytes(self.caches,
                                                      self.max_batch)
        return rep

    # ------------------------------------------------------------------
    # Paged-state serialization (drain / restore)
    # ------------------------------------------------------------------

    def export_paged_state(self):
        """(caches, pool_meta): the device page pools (every layer's paged
        KV leaves -- the bytes behind the warm prefix cache) and the pool's
        JSON-able bookkeeping.  Drain retires live slots first, so what
        survives is the prefix index and its pages.  Kv-head- and
        channel-split leaves come back whole."""
        if not self.paged:
            raise ValueError("export_paged_state on an unpaged engine")
        return sharding.whole_tree(self.caches), self.pool.export_meta()

    def import_paged_state(self, caches, pool_meta: dict):
        """Adopt a drained engine's page pools and prefix index (the
        inverse of :meth:`export_paged_state`).  The geometry must match
        this engine's; every cache leaf -- the pools and any recurrent
        layer's per-slot states -- is copied into this engine's own
        tensors, which keep their addresses (each kv-head or channel shard
        takes its slice of a whole leaf)."""
        if not self.paged:
            raise ValueError("import_paged_state on an unpaged engine")
        if (pool_meta["num_pages"] != self.num_pages
                or pool_meta["page_size"] != self.page_size):
            raise ValueError(
                f"paged-state geometry mismatch: checkpoint has "
                f"{pool_meta['num_pages']} pages x {pool_meta['page_size']} "
                f"rows, engine was built with {self.num_pages} x "
                f"{self.page_size}")
        for mine, theirs in zip(self.caches, caches):
            for kind, sub in mine.items():
                if sub is None:     # an encoder-decoder's unfilled cross_kv
                    continue
                for name, buf in sub.items():
                    sharding.copy_into(buf,
                                       torch.as_tensor(theirs[kind][name]))
        self.pool = pages_lib.PagePool.from_meta(pool_meta)

    def run_to_completion(self):
        """Drain queue + slots; returns every request retired since the
        last call."""
        while self.step():
            pass
        return self.take_finished()
