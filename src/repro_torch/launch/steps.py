"""Serving step factories (counterpart of the serving half of
``repro/launch/steps.py``): ``decode_step`` and ``prefill_chunk_step``.

Both run the deployed packed path (quant_mode 'packed' when the config
quantizes).  Where the reference jits them with ``donate_argnums=(1,)``, the
port writes K/V into the preallocated cache tensors in place: the returned
caches are the same tensors that came in.  Host-side inputs (numpy token
windows, slot offsets, valid counts, block tables) move to the card once
per step, and the write indices -- ragged slots, or with a block table
(physical page, row) per token -- are worked out on the host, so a step
queues its kernels without waiting on the card.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, lm


def quant_mode_for(cfg, kind: str) -> str:
    if not cfg.quant.enabled:
        return "none"
    return {"train": "qat", "prefill": "qat", "prefill_chunk": "packed",
            "decode": "packed"}[kind]


def _window(params, caches, batch, index, valid, width, block_tables=None):
    """Device tensors for one [B, width] window: tokens, positions, offsets,
    valid counts, the write indices (worked out on the host) and the
    block table (None for contiguous caches)."""
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    b = tokens.shape[0]
    idx = torch.as_tensor(index, dtype=torch.int32).cpu()
    idx = idx.expand(b) if idx.dim() == 0 else idx
    pos = idx[:, None] + torch.arange(width, dtype=torch.int32)
    vld = None if valid is None else torch.as_tensor(valid).cpu()
    k0 = caches[0]["attn"]["k"]
    if block_tables is None:
        idx, vld, write = attention.ragged_window(idx, vld, b, width,
                                                  k0.shape[1], dev)
        bt = None
    else:
        idx, vld, write, bt = attention.paged_window(
            idx, vld, torch.as_tensor(block_tables).cpu(), b, width,
            k0.shape[1], k0.shape[0], dev)
    return ({"tokens": tokens.to(dev), "positions": pos.to(dev)}, idx, vld,
            write, bt)


def make_decode_step(cfg, *, backend: str = "auto"):
    """Single-token ragged decode step.

    ``index`` [B] (or a scalar) is each slot's position; ``valid`` [B] is 1
    for a live slot and 0 for a dead one (no cache write, output ignored);
    ``block_tables`` [B, pages_per_slot] int32 when the caches are paged
    pools.  Returns (logits [B, vocab], caches)."""
    qmode = quant_mode_for(cfg, "decode")

    def decode_step(params, caches, batch, index, valid=None,
                    block_tables=None):
        dec, idx, vld, write, bt = _window(params, caches, batch, index,
                                           valid, 1, block_tables)
        logits, _, caches = lm.forward(
            params, cfg, dec, quant_mode=qmode, caches=caches,
            cache_index=idx, cache_valid=vld, write=write, block_tables=bt,
            backend=backend)
        return logits[:, -1], caches

    return decode_step


def make_prefill_chunk_step(cfg, *, backend: str = "auto"):
    """Chunked-prefill step over a [B, chunk] token window per slot.

    ``index`` [B] is each slot's write offset; ``valid`` [B] how many of
    the window's tokens are real (1 lets a decode-phase slot ride along
    with its pending token, 0 = dead slot); ``block_tables`` as for the
    decode step.  Returns (logits of each row's last valid token
    [B, vocab], caches)."""
    qmode = quant_mode_for(cfg, "prefill_chunk")

    def prefill_chunk_step(params, caches, batch, index, valid,
                           block_tables=None):
        c = torch.as_tensor(batch["tokens"]).shape[1]
        dec, idx, vld, write, bt = _window(params, caches, batch, index,
                                           valid, c, block_tables)
        logits, _, caches = lm.forward(
            params, cfg, dec, quant_mode=qmode, caches=caches,
            cache_index=idx, cache_valid=vld, write=write, block_tables=bt,
            backend=backend)
        last = torch.clamp(vld.to(torch.int64) - 1, 0, c - 1)
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, last], caches

    return prefill_chunk_step
