"""Speculative decoding with a sub-byte draft model (counterpart of
``repro/serve/speculative.py``).

A second copy of the SAME checkpoint, packed at ``draft_w_bits`` (weights
and activations; with ``dense_store`` its words take w_bits a value in
device memory), drafts ``k`` greedy tokens a slot in one step (the draft
graph unrolls k + 1 single-token forwards, launch/steps.py); the target
then scores the whole drafted chain in one [B, k+1] verify window that
returns every position's logits, and host-side rejection sampling commits
the longest target-faithful prefix.

The rule (greedy draft = a delta proposal): accept draft ``d`` with
probability ``p(d)``, ``p`` the TARGET distribution after the slot's
temperature / top-k transform (:func:`probs_for`, the transform plain
sampling uses); on rejection resample from ``p`` with ``d`` masked out.
The committed token's marginal is then ``p`` exactly, so speculation
changes throughput, never the output distribution; at temperature 0 it
degenerates to argmax equality and the output is plain decode's token for
token.  When all ``k`` drafts are accepted the window's last row is a free
bonus token, so a cycle commits 1 .. k+1 tokens.

Cache bookkeeping: the verify window writes K/V at ``pos .. pos + limit``;
chunked writes equal sequential writes, so the accepted prefix's rows are
exact and the rejected suffix stays in the cache, masked, until a later
pass overwrites it -- rollback is not advancing ``slot_pos``.  The draft
keeps its own caches (paged: its own pool of ``max_batch x
pages_per_slot`` pages with no prefix sharing -- the draft always replays
the full prompt, because a target-side prefix skip would leave its cache
without those rows).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve import pages as pages_lib
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.prepare import (build_layer_plans,
                                       prepare_serving_params,
                                       serving_param_bytes)

__all__ = ["DraftModel", "accept_tokens", "draft_model_config",
           "probs_for", "sample_token"]


# ---------------------------------------------------------------------------
# Sampling (shared with ServingEngine's plain emission)
# ---------------------------------------------------------------------------

def probs_for(logits_row, sp: SamplingParams) -> np.ndarray:
    """The slot's target distribution: the temperature / top-k transform of
    one logits row, in float64 on the host.  Greedy (temperature <= 0) has
    no distribution -- callers take the argmax."""
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
    """Sample one token (greedy / temperature / top-k) from a logits row
    with the slot's numpy Generator: the one sampling primitive of plain
    decode and of the speculative bonus / resample."""
    if sp.greedy:
        return int(np.argmax(np.asarray(logits_row, np.float64)))
    probs = probs_for(logits_row, sp)
    return int(rng.choice(len(probs), p=probs))


def accept_tokens(window_logits, drafted, sp: SamplingParams,
                  rng) -> list[int]:
    """Rejection-sample one speculative cycle for one slot.

    ``window_logits`` [w, vocab] are the verify window's rows, ``w ==
    len(drafted) + 1``: row ``i`` scores ``drafted[i]``, the last row is
    the bonus distribution used only when every draft is accepted.
    Returns the committed tokens, 1 .. w of them: the accepted drafts,
    then one target-sampled token (the resample or the bonus), so
    ``len(result) - 1`` drafts were accepted."""
    out: list[int] = []
    for i, d in enumerate(drafted):
        d = int(d)
        row = window_logits[i]
        if sp.greedy:
            t = int(np.argmax(np.asarray(row, np.float64)))
            out.append(t)
            if t != d:
                return out
            continue
        p = probs_for(row, sp)
        if rng.random() < p[d]:
            out.append(d)
            continue
        q = p.copy()
        q[d] = 0.0
        tot = q.sum()
        if tot <= 0.0:
            # p was numerically a point mass on d, so rejection had
            # probability ~0: committing d keeps the marginal exact
            out.append(d)
            continue
        out.append(int(rng.choice(len(q), p=q / tot)))
        return out
    out.append(sample_token(window_logits[len(drafted)], sp, rng))
    return out


# ---------------------------------------------------------------------------
# The draft model
# ---------------------------------------------------------------------------

def draft_model_config(cfg, econf: EngineConfig):
    """The draft's config: the target's with weights and activations
    dropped to ``draft_w_bits`` (activations to at most that) and,
    optionally, ``draft_kv_bits`` for its cache; the lane layout reset to
    the int16 x2 default, feasible at every sub-byte width.  On an
    unpacked (or unquantized) engine the draft IS the target config."""
    q = cfg.quant
    if not (econf.packed and q.enabled):
        return cfg
    kv = q.kv_bits if econf.draft_kv_bits is None else econf.draft_kv_bits
    dq = q.replace(w_bits=econf.draft_w_bits,
                   a_bits=min(q.a_bits, econf.draft_w_bits),
                   kv_bits=kv, lane_dtype="int16", n_pack=2,
                   pack_shift=None)
    return cfg.replace(quant=dq)


class DraftModel:
    """The draft side of one speculative :class:`ServingEngine`: the
    re-packed draft tree and its plans, its caches and -- paged -- its own
    page pool and block tables, and the per-slot state.

    The pool holds ``max_batch x pages_per_slot`` pages (every slot's
    worst case, no sharing), so a draft reservation cannot fail once the
    target's has succeeded.  With a ``shard_plan`` (serve/shard.ShardPlan,
    the target's) the draft is laid out as the target is: its packed
    leaves split their columns (the dense store's words pack along K, as
    lanes do, so no column straddles a shard), its plans are the
    per-shard products, and its caches -- contiguous, or the pool with its
    page axis whole -- split their kv heads; an unpacked draft shares the
    target's placed params.  Per slot: ``fed`` (prompt tokens the draft
    has consumed: it replays the FULL prompt even when the target
    prefix-skips) and the stashed first-token logits of a slot whose
    target finished its prompt before the draft did.  The engine binds the
    steps (``draft_step``, ``prefill_step``: graphs on the card)."""

    def __init__(self, cfg, raw_params, econf: EngineConfig, *,
                 max_batch: int, max_len: int, device, target_params,
                 backend: str = "auto", shard_plan=None):
        self.k = econf.speculative_k
        self.cfg = draft_model_config(cfg, econf)
        self.max_batch = max_batch
        self.max_len = max_len
        self.packed = econf.packed and self.cfg.quant.enabled
        # the config the draft's steps run: the float path when unpacked,
        # as the engine runs its own
        self.run_cfg = self.cfg if self.packed else self.cfg.replace(
            quant=self.cfg.quant.replace(enabled=False))
        # Re-pack the same checkpoint at the draft's precision.  The
        # learned step sizes are calibrated for the target's bits: they
        # are dropped (scales re-derived for the draft grid) only when the
        # grids differ; at matching bits keeping them makes the draft the
        # target numerically (acceptance 1).
        recalib = (self.cfg.quant.w_bits != cfg.quant.w_bits
                   or self.cfg.quant.a_bits != cfg.quant.a_bits)
        # autotune: the draft's layouts are swept before its repack and
        # its signatures warm-tuned before planning, as the reference's
        self.params = prepare_serving_params(
            raw_params, self.cfg, dense_store=econf.dense_store,
            autotune=econf.autotune, recalibrate=recalib,
            device=device) if self.packed else target_params
        self.shard_plan = shard_plan
        self.plans = build_layer_plans(
            self.params, self.run_cfg, batch_rows=max_batch,
            prefill_rows=max_batch * econf.prefill_chunk,
            backend=backend, autotune=econf.autotune,
            shard_plan=shard_plan) if self.packed else {}
        if shard_plan is not None and self.packed:
            self.params = shard_plan.place_params(self.params)
        self.paged = econf.paged
        kv_bits = self.cfg.quant.kv_bits
        self.pages_per_slot = None
        if self.paged:
            pages_lib.validate_page_size(econf.page_size, kv_bits)
            self.page_size = econf.page_size
            self.pages_per_slot = -(-max_len // econf.page_size)
            self.num_pages = max_batch * self.pages_per_slot
            self.page_bytes = lm.cache_page_bytes(self.cfg, self.page_size)
            self.caches = lm.init_caches(
                self.cfg, max_batch, max_len, dtype=torch.bfloat16,
                page_size=self.page_size, num_pages=self.num_pages,
                device=device)
            self.pool = pages_lib.PagePool(self.num_pages, self.page_size,
                                           kv_bits)
            self.block_tables = np.zeros((max_batch, self.pages_per_slot),
                                         np.int32)
            self._extent = [0] * max_batch
        else:
            self.caches = lm.init_caches(self.cfg, max_batch, max_len,
                                         dtype=torch.bfloat16, device=device)
        if shard_plan is not None:
            self.caches = shard_plan.place_caches(self.caches)
        self.fed = np.zeros(max_batch, np.int32)
        self._stash: dict[int, np.ndarray] = {}
        self.draft_step = self.prefill_step = None    # bound by the engine

    # -- per-slot lifecycle --------------------------------------------

    def begin_slot(self, slot: int, req) -> None:
        """Reset the slot's draft state at admission and, paged, reserve
        its whole write extent (cannot fail: the pool's sizing)."""
        self.fed[slot] = 0
        self._stash.pop(slot, None)
        if self.paged:
            written = len(req.prompt) + req.max_new_tokens - 1
            n_pages = -(-written // self.page_size)
            got = self.pool.alloc(n_pages)
            if got is None:    # unreachable by sizing; fail loudly if not
                raise RuntimeError(
                    f"draft page pool exhausted for slot {slot}: asked "
                    f"{n_pages} of {self.num_pages} pages")
            table = self.block_tables[slot]
            table[:] = 0
            table[:n_pages] = got
            self._extent[slot] = n_pages

    def release_slot(self, slot: int) -> None:
        self._stash.pop(slot, None)
        if self.paged:
            for p in self.block_tables[slot][:self._extent[slot]]:
                self.pool.release(int(p))
            self.block_tables[slot][:] = 0
            self._extent[slot] = 0

    # -- the first-token stash (target prefix-skipped ahead of the draft)

    def prompt_done(self, slot: int, req) -> bool:
        return int(self.fed[slot]) >= len(req.prompt)

    def stash(self, slot: int, logits_row: np.ndarray) -> None:
        self._stash[slot] = logits_row

    def pop_stash(self, slot: int):
        return self._stash.pop(slot, None)

    def has_stash(self, slot: int) -> bool:
        return slot in self._stash

    # -- reporting ------------------------------------------------------

    def describe(self) -> dict:
        """The ``speculative`` section of ``capacity_report``: the draft's
        precision, its param bytes on the device, by shard under a
        ShardPlan, and, paged, its pool."""
        rep = {
            "speculative_k": self.k,
            "draft_w_bits": self.cfg.quant.w_bits if self.packed else 0,
            "draft_a_bits": self.cfg.quant.a_bits if self.packed else 0,
            "draft_kv_bits": (self.cfg.quant.kv_bits or 16)
            if self.packed else 16,
            "draft_packed": self.packed,
            "draft_param_bytes": serving_param_bytes(self.params)
            if self.packed else 0,
        }
        if self.shard_plan is not None:
            rep["draft_shard_param_bytes"] = \
                self.shard_plan.shard_param_bytes(self.params) \
                if self.packed else None
        if self.paged:
            rep.update(draft_num_pages=self.num_pages,
                       draft_page_bytes=self.page_bytes,
                       draft_pool_bytes=self.num_pages * self.page_bytes)
        return rep
