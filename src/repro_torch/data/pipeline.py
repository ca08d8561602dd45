"""Deterministic, sharded, checkpointable synthetic LM data pipeline (a
numpy-only copy of ``repro/data/pipeline.py``: the same ``(seed, step)``
gives byte-equal batches in both packages).

Production shape: an infinite token stream partitioned by (host, shard) with
a counter-based PRNG so that (a) every batch is reproducible from (seed,
step) alone, (b) restoring `step` from a checkpoint resumes the exact stream
(no replay drift), and (c) elastic restarts with a different data-parallel
degree re-partition the stream without changing the global sequence.

The synthetic distribution is a Zipf-ish unigram mix with short repeated
motifs -- enough structure that a ~100M model's loss visibly drops in a
few hundred steps (repro_torch/examples/train_lm.py) while requiring no
external corpus.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    motif_count: int = 64


class SyntheticLMStream:
    """step -> batch dict, stateless per step (counter-based)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed unigram distribution (Zipf) + motif table
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks ** 1.1
        self.probs = probs / probs.sum()
        self.motifs = root.integers(
            0, v, size=(cfg.motif_count, cfg.motif_len))

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        tokens = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self.probs)
        # plant motifs: ~25% of positions continue a motif deterministically
        n_plants = (b * s) // (4 * cfg.motif_len)
        rows = rng.integers(0, b, n_plants)
        cols = rng.integers(0, s + 1 - cfg.motif_len, n_plants)
        which = rng.integers(0, cfg.motif_count, n_plants)
        for r, c, w in zip(rows, cols, which):
            tokens[r, c:c + cfg.motif_len] = self.motifs[w]
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}

    def state(self, step: int) -> dict:
        return {"seed": self.cfg.seed, "step": int(step)}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict) -> "SyntheticLMStream":
        assert state["seed"] == cfg.seed, "data seed mismatch on restore"
        return cls(cfg)


def family_batch(cfg, rng, b=2, s=16):
    """A random batch with the inputs ``cfg``'s family takes (the
    counterpart of ``tests/test_archs_smoke.py::make_batch``, in numpy):
    ``tokens`` [b, s] and the labels; a vision config adds a 4-token image
    prefix (``embeds`` [b, 4, frontend_dim], ``positions`` over the whole
    sequence and ``positions3`` [3, b, 4 + s] with t = h = w, the prefix's
    labels -1), an audio config 8 encoder embeddings (``enc_embeds``).
    Returns ``(batch, labels)``; ``rng`` is a numpy Generator."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "vision":
        si = 4
        batch["embeds"] = rng.normal(size=(b, si, cfg.frontend_dim)).astype(
            np.float32)
        total = si + s
        pos = np.broadcast_to(np.arange(total, dtype=np.int32)[None],
                              (b, total)).copy()
        batch["positions"] = pos
        batch["positions3"] = np.broadcast_to(pos[None], (3, b, total)).copy()
        labels = np.pad(labels, ((0, 0), (si, 0)), constant_values=-1)
    if cfg.frontend == "audio":
        batch["enc_embeds"] = rng.normal(size=(b, 8, cfg.frontend_dim)) \
            .astype(np.float32)
    return batch, labels
