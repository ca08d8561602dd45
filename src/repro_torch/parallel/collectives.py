"""Distributed-optimization collectives (counterpart of
``repro/parallel/collectives.py``).

* int8 gradient compression with error feedback: each gradient leaf is
  quantized to int8 over blocks of 256 with f32 absmax / 127 scales and
  dequantized again, so what a data-parallel reduce would carry is the
  int8 words and the scales; the quantization residual is carried in the
  train state (``error_feedback``, f32 like the params' shapes) and added
  back at the next step.  ``launch/steps.make_train_step(compress_grads=
  True)`` runs it after the microbatch sum and before the clip, in a
  ``grad_compress`` profiler range.

* :func:`all_gather_matmul`: the reference's overlapped tensor-parallel
  matmul, a ring over the ``model`` shards in which each shard multiplies
  the block of ``x`` it holds while that block hops on to the next shard.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim import adamw
from repro_torch.parallel import sharding


def quantize_grad(g, block: int = 256):
    """f32 ``g`` flattened and zero-padded to blocks of ``block``:
    (int8 [blocks, block], f32 scales [blocks, 1]), each value rounded
    half to even onto absmax / 127 steps (the 8-bit moments' quantizer)."""
    return adamw._qm(g, block)


def dequantize_grad(q, scale, shape):
    """The f32 tensor of ``shape`` that :func:`quantize_grad` encoded."""
    return adamw._dq(q, scale, shape)


def compress_grads_with_feedback(grads, state):
    """int8-compress ``grads``, carrying the residual in
    ``state['error_feedback']``.

    Returns (decompressed f32 grads, updated state).  When the state has
    no ``error_feedback`` entry the compression runs without feedback and
    the state comes back as it was."""
    feedback = state.get("error_feedback")
    gs = tree_lib.leaves(grads)
    es = [None] * len(gs) if feedback is None else tree_lib.leaves(feedback)
    deq, resid = [], []
    for g, e in zip(gs, es):
        g32 = g.to(torch.float32) + (e if e is not None else 0.0)
        q, scale = quantize_grad(g32)
        d = dequantize_grad(q, scale, g32.shape)
        deq.append(d)
        if e is not None:
            resid.append(g32 - d)
    if feedback is None:
        return tree_lib.unflatten(grads, deq), state
    new_state = dict(state)
    new_state["error_feedback"] = tree_lib.unflatten(feedback, resid)
    return tree_lib.unflatten(grads, deq), new_state


# ---------------------------------------------------------------------------
# Overlapped collective matmul
# ---------------------------------------------------------------------------

def all_gather_matmul(x, w, mesh, axis: str = "model"):
    """y = all_gather(x, axis) @ w, as the reference's ring.

    ``x`` [m, k] is split on its last dim and ``w`` [k, n] on its first
    over the ``axis`` shards of ``mesh`` (``sharding.Sharded``, one part a
    shard on that shard's device).  Each shard gathers ``w`` once; then
    for p steps it multiplies the block of ``x`` it holds by the rows of
    ``w`` that block came from, adds that into its accumulator (kept in
    ``x``'s dtype, as the reference keeps it) and passes the block on to
    the next shard (``.to()`` its device).  Every shard ends holding the
    whole y; the home shard's (the first) is returned, on its device."""
    p = mesh.shape[axis]
    xs, ws = sharding.parts(x), sharding.parts(w)
    if len(xs) != p or len(ws) != p:
        raise ValueError(f"x and w must be split {p} ways over {axis!r}, "
                         f"got {len(xs)} and {len(ws)} parts")
    devs = [t.device for t in xs]
    kb = ws[0].shape[0]
    # gather w once per shard (weights stationary)
    w_full = [torch.cat([t.to(d) for t in ws], dim=0) for d in devs]
    acc = [torch.zeros((xs[i].shape[0], ws[0].shape[1]), dtype=xs[i].dtype,
                       device=devs[i]) for i in range(p)]
    blk = list(xs)
    for step in range(p):
        for i in range(p):
            # after `step` hops of the (s -> s+1) ring, shard i holds the
            # x block that started on shard (i - step) mod p
            src = (i - step) % p
            acc[i] = acc[i] + blk[i] @ w_full[i][src * kb:(src + 1) * kb]
        blk = [blk[(i - 1) % p].to(devs[i]) for i in range(p)]
    return acc[0]
