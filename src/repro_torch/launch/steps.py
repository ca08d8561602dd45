"""Step factories (counterpart of ``repro/launch/steps.py``).

Training: :func:`make_train_step` (fake-quant forward and backward with
microbatch accumulation, global-norm clip, AdamW) over a state from
:func:`make_train_state`, and the fake-quant prefill
:func:`make_prefill_step`; they run eagerly (op by op).

Serving: ``decode_step`` and ``prefill_chunk_step``,
and speculative decoding's ``draft_step`` and ``verify_chunk_step``, run
op by op (:func:`make_decode_step`, :func:`make_prefill_chunk_step`,
:func:`make_draft_step`, :func:`make_verify_chunk_step`) or over static
device buffers replayed as CUDA graphs (:func:`graphed_serving_steps` and
:func:`graphed_speculative_steps`, the counterparts of the reference's
``jitted_serving_steps`` and ``jitted_speculative_steps``).

Both run the deployed packed path (quant_mode 'packed' when the config
quantizes).  Where the reference jits them with ``donate_argnums=(1,)``, the
port writes K/V into the preallocated cache tensors in place: the returned
caches are the same tensors that came in.  Host-side inputs (numpy token
windows, slot offsets, valid counts, block tables) move to the card once
per step; the positions and the window's destination rows
(``attention.window``) are worked out on the card, in fixed shapes, so a
step never waits on the card and a graph can capture it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import (cache_write, quant_pack, ulppack_attention,
                                 ulppack_matmul)
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import attention, common, lm
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import collectives, sharding


def quant_mode_for(cfg, kind: str) -> str:
    if not cfg.quant.enabled:
        return "none"
    return {"train": "qat", "prefill": "qat", "prefill_chunk": "packed",
            "decode": "packed"}[kind]


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def _split_micro(batch: dict, n: int) -> list:
    """``n`` equal microbatches along the batch axis (axis 1 of
    ``positions3`` [3, B, S], axis 0 of everything else); a batch that
    ``n`` does not divide raises, as the reference's reshape does."""
    parts = {}
    for k, v in batch.items():
        dim = 1 if k == "positions3" else 0
        if v.shape[dim] % n:
            raise ValueError(f"{k}: a batch of {v.shape[dim]} does not "
                             f"split into {n} microbatches")
        parts[k] = torch.split(v, v.shape[dim] // n, dim=dim)
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(cfg, *, adamw_cfg: adamw.AdamWConfig | None = None,
                    schedule: str = "cosine", peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    clip_norm: float = 1.0, compress_grads: bool = False):
    """``train_step(state, batch) -> (state, metrics)``, run eagerly.

    The forward is ``lm.forward`` in the train quant mode ('qat' when the
    config quantizes), each block recomputed in the backward unless
    ``cfg.parallel.remat == 'none'``; the loss ``lm.loss_fn``.  With
    ``cfg.parallel.microbatches`` n > 1 the batch is split in n, the
    gradients summed in f32 and divided by n, as are loss and ce.  With
    ``compress_grads`` the gradients then go through the int8 round trip
    of ``parallel/collectives.compress_grads_with_feedback`` (the residual
    carried in ``state['error_feedback']`` when the state has one:
    :func:`make_train_state`'s ``error_feedback``), in a ``grad_compress``
    profiler range.  Then the global-norm clip, the AdamW update at the
    schedule's lr for ``state['step']``, and ``apply_updates`` (each
    param back to its dtype), in an ``optimizer`` profiler range.  The
    state is not modified; a new one is returned.  Metrics: ``loss``,
    ``ce``, ``grad_norm``, ``lr``, 0-d f32 tensors."""
    adamw_cfg = adamw_cfg or adamw.AdamWConfig(
        eightbit_moments=cfg.parallel.eightbit_moments)
    sched = schedules.get_schedule(schedule)
    qmode = quant_mode_for(cfg, "train")
    remat = cfg.parallel.remat != "none"
    n_micro = max(1, cfg.parallel.microbatches)

    def grads_of(params, mb):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_lib.leaves(params)]
        logits, aux, _ = lm.forward(tree_lib.unflatten(params, leaves), cfg,
                                    mb, quant_mode=qmode, remat=remat)
        loss, ce = lm.loss_fn(logits, mb["labels"], aux)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), ce.detach(), grads

    def train_step(state, batch):
        params, step = state["params"], state["step"]
        dev = step.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        lr = sched(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                   total_steps=total_steps)
        if n_micro == 1:
            loss, ce, grads = grads_of(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in tree_lib.leaves(params)]
            loss = ce = 0.0
            for mb in _split_micro(batch, n_micro):
                lossi, cei, gs = grads_of(params, mb)
                for acc, g in zip(grads, gs):
                    acc.add_(g)
                del gs
                grads = sharding.constrain_like_params(grads, cfg)
                loss, ce = loss + lossi, ce + cei
            grads = [g / n_micro for g in grads]
            loss, ce = loss / n_micro, ce / n_micro
        grads = tree_lib.unflatten(params, grads)
        if compress_grads:
            with torch.no_grad(), \
                    torch.profiler.record_function("grad_compress"):
                grads, state = collectives.compress_grads_with_feedback(
                    grads, state)
        with torch.no_grad(), \
                torch.profiler.record_function("optimizer"):
            grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
            updates, opt_state = adamw.update(
                grads, state["opt_state"], params, lr, adamw_cfg)
            del grads
            params = adamw.apply_updates(params, updates)
        new_state = dict(state)
        new_state.update(params=params, opt_state=opt_state, step=step + 1)
        return new_state, {"loss": loss, "ce": ce, "grad_norm": gnorm,
                           "lr": lr}

    return train_step


def make_train_state(params, adamw_cfg: adamw.AdamWConfig | None = None,
                     error_feedback: bool = False, cfg=None) -> dict:
    """``{"params", "opt_state", "step"}`` (step an int32 0-d tensor on the
    params' device); 8-bit moments when ``adamw_cfg`` -- or, without one,
    ``cfg.parallel`` -- asks for them.  ``error_feedback`` adds f32 zero
    residuals of the params' shapes, for compressed gradients."""
    if adamw_cfg is None:
        adamw_cfg = adamw.AdamWConfig(
            eightbit_moments=cfg.parallel.eightbit_moments if cfg is not None
            else False)
    dev = tree_lib.leaves(params)[0].device
    state = {"params": params, "opt_state": adamw.init(params, adamw_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if error_feedback:
        state["error_feedback"] = tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def make_prefill_step(cfg, max_len: int):
    """``prefill_step(params, batch) -> (last logits [B, vocab], caches)``:
    fresh caches of ``max_len`` rows in the compute dtype on the params'
    device, filled with the prompt's K/V (rows 0 .. S-1, an image prefix's
    first) by the fake-quant forward ('qat' when the config quantizes),
    under no_grad.  The whole batch goes through: ``tokens`` and, where
    given, ``embeds``, ``positions``, ``positions3`` and ``enc_embeds``
    (an encoder-decoder's caches then hold its cross K/V)."""
    qmode = quant_mode_for(cfg, "prefill")

    def prefill_step(params, batch):
        dev = params["embed"]["table"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].to(torch.int64)
        caches = lm.init_caches(cfg, batch["tokens"].shape[0], max_len,
                                dtype=common.dtype_of(cfg.compute_dtype),
                                device=dev)
        with torch.no_grad():
            logits, _, caches = lm.forward(params, cfg, batch,
                                           quant_mode=qmode, caches=caches)
        return logits[:, -1], caches

    return prefill_step


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def _inputs(batch, index, valid, block_tables, dev):
    """Device tensors of one window's inputs: tokens [B, w] int64, offsets
    [B] int32 (a scalar ``index`` is shared by every row), valid counts [B]
    int32 (None: the whole window) and the block table (or None)."""
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64).to(dev)
    b, w = tokens.shape
    idx = torch.as_tensor(index, dtype=torch.int32)
    idx = (idx.expand(b) if idx.dim() == 0 else idx).to(dev)
    vld = (torch.full((b,), w, dtype=torch.int32) if valid is None
           else torch.as_tensor(valid, dtype=torch.int32)).to(dev)
    bt = (None if block_tables is None
          else torch.as_tensor(block_tables, dtype=torch.int32).to(dev))
    return tokens, idx, vld, bt


def _positions3(batch, dev):
    """A batch's M-RoPE ids [3, B, w] as an int32 device tensor, or None."""
    p3 = batch.get("positions3")
    return None if p3 is None else torch.as_tensor(
        p3, dtype=torch.int32).to(dev)


def _forward(cfg, qmode, backend, params, caches, tokens, idx, vld, bt,
             positions3=None):
    """The body of both steps on device tensors: positions and destination
    rows (ring slots for a sliding-window config; none for an
    attention-free stack) on the device, then the forward; returns logits
    [B, w, vocab].  An M-RoPE config without ``positions3`` gets every
    component at the cache position (t = h = w), as the reference engine
    feeds it.  Which cache read the forward takes
    (``attention.use_fused_decode``, with the kill-switch) is fixed when
    the body runs, so a captured graph keeps it."""
    b, w = tokens.shape
    pos = idx[:, None] + torch.arange(w, dtype=torch.int32,
                                      device=tokens.device)
    batch = {"tokens": tokens, "positions": pos}
    if cfg.mrope:
        batch["positions3"] = (pos[None].expand(3, b, w) if positions3 is None
                               else positions3)
    kv = lm.first_attn_cache(caches)
    dest = None if kv is None else attention.window(
        idx, vld, bt, b, w, kv["k"].shape, tokens.device,
        sliding_window=cfg.sliding_window)[2]
    logits, _, _ = lm.forward(
        params, cfg, batch, quant_mode=qmode, caches=caches, cache_index=idx,
        cache_valid=vld, dest=dest, block_tables=bt, backend=backend)
    return logits


def _draft(cfg, qmode, backend, params, caches, tokens, idx, lim, bt, k):
    """The draft step's body on device tensors: k + 1 single-token forwards
    from each row's last token ``tokens[:, 0]`` at positions ``idx + i``;
    forward ``i`` writes its K/V row iff ``i < lim + 1`` (``lim`` -1 gates
    every write off), and forwards 0 .. k-1 feed their argmax to the next.
    The k-th forward runs for its cache write alone: when every draft is
    accepted the next cycle needs the last draft's K/V.  Returns the
    drafts [B, k] int32 (rows past ``lim`` are garbage the host ignores)."""
    tok = tokens[:, :1]
    drafted = []
    for i in range(k + 1):
        logits = _forward(cfg, qmode, backend, params, caches, tok, idx + i,
                          (lim + 1 > i).to(torch.int32), bt)
        if i < k:
            # the pad-vocab bias already keeps the argmax in the real vocab
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            drafted.append(tok)
    return torch.cat(drafted, dim=1).to(torch.int32)


def _last_valid(logits, vld):
    """Each row's logits at its last valid token (row 0 for a dead row)."""
    last = torch.clamp(vld.to(torch.int64) - 1, 0, logits.shape[1] - 1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last]


def make_decode_step(cfg, *, backend: str = "auto"):
    """Single-token ragged decode step, run op by op.

    ``index`` [B] (or a scalar) is each slot's position; ``valid`` [B] is 1
    for a live slot and 0 for a dead one (no cache write, output ignored);
    ``block_tables`` [B, pages_per_slot] int32 when the caches are paged
    pools; ``batch["positions3"]`` [3, B, 1], when given, an M-RoPE
    config's ids.  Returns (logits [B, vocab], caches)."""
    qmode = quant_mode_for(cfg, "decode")

    def decode_step(params, caches, batch, index, valid=None,
                    block_tables=None):
        dev = params["embed"]["table"].device
        logits = _forward(cfg, qmode, backend, params, caches,
                          *_inputs(batch, index, valid, block_tables, dev),
                          _positions3(batch, dev))
        return logits[:, -1], caches

    return decode_step


def make_prefill_chunk_step(cfg, *, backend: str = "auto"):
    """Chunked-prefill step over a [B, chunk] token window per slot, run op
    by op.

    ``index`` [B] is each slot's write offset; ``valid`` [B] how many of
    the window's tokens are real (1 lets a decode-phase slot ride along
    with its pending token, 0 = dead slot); ``block_tables`` and
    ``positions3`` as for the decode step.  Returns (logits of each row's
    last valid token [B, vocab], caches)."""
    qmode = quant_mode_for(cfg, "prefill_chunk")

    def prefill_chunk_step(params, caches, batch, index, valid,
                           block_tables=None):
        dev = params["embed"]["table"].device
        inputs = _inputs(batch, index, valid, block_tables, dev)
        logits = _forward(cfg, qmode, backend, params, caches, *inputs,
                          _positions3(batch, dev))
        return _last_valid(logits, inputs[2]), caches

    return prefill_chunk_step


def make_verify_chunk_step(cfg, *, backend: str = "auto"):
    """Speculative verify step, run op by op: a prefill-chunk window that
    returns every position's logits [B, w, vocab] (row j scores the token
    at ``index + j + 1``), with the prefill chunk's cache semantics
    (writes at ``index`` gated by the valid prefix ``valid``).  Positions
    past the accepted prefix keep stale K/V, masked until a later pass
    overwrites them: rollback is not advancing the slot position."""
    qmode = quant_mode_for(cfg, "prefill_chunk")

    def verify_chunk_step(params, caches, batch, index, valid,
                          block_tables=None):
        dev = params["embed"]["table"].device
        return _forward(cfg, qmode, backend, params, caches,
                        *_inputs(batch, index, valid, block_tables,
                                 dev)), caches

    return verify_chunk_step


def make_draft_step(cfg, k: int, *, backend: str = "auto"):
    """Draft ``k`` greedy tokens a slot in one step, run op by op.

    ``cfg`` is the DRAFT config (serve/speculative.draft_model_config).
    ``batch["tokens"][:, 0]`` is each slot's last committed token,
    ``index`` [B] its position, ``limit`` [B] its cap (``min(k, remaining
    - 1)``, -1 for a dead slot): forward ``i`` writes its K/V row iff
    ``i < limit + 1``, so the draft never writes past the slot's reserved
    extent, and a dead slot writes nothing.  Drafting is greedy (a delta
    proposal), so the step needs no random numbers.  Returns (drafts
    [B, k] int32, caches)."""
    qmode = quant_mode_for(cfg, "decode")

    def draft_step(params, caches, batch, index, limit, block_tables=None):
        dev = params["embed"]["table"].device
        tokens, idx, lim, bt = _inputs(batch, index, limit, block_tables,
                                       dev)
        return _draft(cfg, qmode, backend, params, caches, tokens, idx, lim,
                      bt, k), caches

    return draft_step


# ---------------------------------------------------------------------------
# Static-buffer steps, captured as CUDA graphs
# ---------------------------------------------------------------------------

#: The launch and call counters of the kernel wrappers a step can reach.
_COUNTED = (quant_pack, ulppack_matmul, ulppack_attention, cache_write)
_COUNTERS = ("kernel_launches", "plain_calls", "mma_launches",
             "dense_mma_launches", "library_launches", "tile_launches")


def _counts() -> dict:
    """A copy of every counter of the kernel wrappers."""
    out = {}
    for mod in _COUNTED:
        for name in _COUNTERS:
            val = getattr(mod, name, None)
            if val is not None:
                out[mod, name] = dict(val) if isinstance(val, dict) else val
    return out


def _count_delta(before: dict, after: dict) -> dict:
    out = {}
    for key, val in after.items():
        was = before[key]
        out[key] = ({k: v - was[k] for k, v in val.items()}
                    if isinstance(val, dict) else val - was)
    return out


def _add_counts(delta: dict, sign: int = 1):
    """Add ``sign`` x ``delta`` to the wrappers' counters, in place."""
    for (mod, name), val in delta.items():
        cur = getattr(mod, name)
        if isinstance(cur, dict):
            for k, v in val.items():
                cur[k] += sign * v
        else:
            setattr(mod, name, cur + sign * val)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, sharding.Sharded):
        yield from tree.parts
    elif isinstance(tree, sharding.Mirrored):
        yield tree.whole
        yield from (p for p in tree.parts if p is not None)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _ptrs(tree) -> list:
    return [t.data_ptr() for t in _leaves(tree)]


#: The steps a StaticStep runs: what its window's fifth input is (valid
#: counts, or the draft's caps) and the value that makes a row dead.
_KINDS = {"decode": ("valid", 0), "prefill_chunk": ("valid", 0),
          "verify": ("valid", 0), "draft": ("limit", -1)}


class StaticStep:
    """One serving step over static device buffers: tokens [B, width]
    int64, offsets [B] int32, valid counts [B] int32 (the draft step: caps
    ``limit``), and with ``block_table_width`` the block table [B,
    block_table_width] int32.  ``kind`` is 'decode' (width 1) or
    'prefill_chunk' (returns the logits of each row's last valid token
    [B, vocab]), 'verify' (returns the whole window's logits [B, width,
    vocab]) or 'draft' (width 1, ``k`` drafts: returns them [B, k] int32).

    A call copies its numpy inputs into the buffers (on the card through
    pinned host staging, ``non_blocking``), runs the step and returns
    (output, caches).  Once :meth:`capture` has run (CUDA), the step is a
    graph replay and the output is the graph's static tensor, overwritten
    by the next call: read it before calling again.  On the CPU the same
    body runs eagerly on the buffers.  The step refuses ``params`` /
    ``caches`` other than the tensors it was built over (their
    ``data_ptr()``s)."""

    def __init__(self, cfg, params, caches, *, kind: str, batch: int,
                 width: int, block_table_width: int | None = None,
                 backend="auto", k: int = 0):
        if kind not in _KINDS:
            raise ValueError(f"unknown step kind {kind!r}")
        if kind == "draft" and (width != 1 or k < 1):
            raise ValueError("the draft step takes one token a row and "
                             "k >= 1 drafts")
        self.kind = kind
        self.k = k
        self._fifth, self._dead = _KINDS[kind]
        self._body = (cfg, quant_mode_for(
            cfg, "decode" if kind == "draft" else
            "prefill_chunk" if kind == "verify" else kind), backend)
        self._params, self._caches = params, caches
        self._param_ptrs, self._cache_ptrs = _ptrs(params), _ptrs(caches)
        dev = self.device = params["embed"]["table"].device
        self.width = width
        self.buffers = {
            "tokens": torch.zeros((batch, width), dtype=torch.int64,
                                  device=dev),
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev),
            self._fifth: torch.full((batch,), self._dead, dtype=torch.int32,
                                    device=dev)}
        if block_table_width is not None:
            self.buffers["block_tables"] = torch.zeros(
                (batch, block_table_width), dtype=torch.int32, device=dev)
        self._staging = self.buffers
        self._copied = None
        if dev.type == "cuda":
            self._staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                            pin_memory=True)
                             for k, v in self.buffers.items()}
            self._copied = torch.cuda.Event()
        self.graph = None
        self.logits = None
        self.workspace = None         # K2's, owned with the graphs
        self.launches: dict = {}      # counters a replay adds
        self.replays = 0
        self.capture_s = 0.0

    def run(self):
        """The step's body on the static buffers (eager)."""
        cfg, qmode, backend = self._body
        b = self.buffers
        args = (cfg, qmode, backend, self._params, self._caches,
                b["tokens"], b["index"], b[self._fifth],
                b.get("block_tables"))
        if self.kind == "draft":
            return _draft(*args, self.k)
        logits = _forward(*args)
        return logits if self.kind == "verify" \
            else _last_valid(logits, b["valid"])

    def capture(self):
        """Capture :meth:`run` into a CUDA graph (its kernels must have run
        once, outside any capture, on these buffers).  The buffers are left
        with every row dead (valid 0, or the draft's cap -1: no cache
        write), as warm-up ran them.  Counts the launches the graph holds;
        each replay adds them to the wrappers' counters.  Raises when the
        capture fails."""
        for name, buf in self.buffers.items():
            buf.fill_(self._dead if name == self._fifth else 0)
        torch.cuda.synchronize(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            logits = self.run()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.launches = _count_delta(before, _counts())
        _add_counts(self.launches, -1)     # captured, not run
        self.graph, self.logits = graph, logits

    def _check(self, params, caches):
        if params is not self._params and _ptrs(params) != self._param_ptrs:
            raise ValueError(f"{self.kind} step: params are not the tensors "
                             f"the step was built over")
        if _ptrs(caches) != self._cache_ptrs:
            raise ValueError(f"{self.kind} step: caches are not the tensors "
                             f"the step was built over")

    def _stage(self, batch, index, valid, block_tables):
        tokens = np.asarray(batch["tokens"])
        want = tuple(self.buffers["tokens"].shape)
        if tokens.shape != want:
            raise ValueError(f"{self.kind} step: tokens {tokens.shape}, the "
                             f"step's window is {want}")
        if (block_tables is None) != ("block_tables" not in self.buffers):
            raise ValueError(f"{self.kind} step: block_tables must be given "
                             f"exactly when the caches are paged")
        if self._copied is not None:
            self._copied.synchronize()      # the last copies read staging
        host = {k: v.numpy() for k, v in self._staging.items()}
        host["tokens"][...] = tokens
        host["index"][...] = index
        if valid is None and self.kind == "draft":
            raise ValueError("draft step: limit must be given")
        host[self._fifth][...] = self.width if valid is None else valid
        if block_tables is not None:
            host["block_tables"][...] = block_tables
        if self._copied is not None:
            for k, buf in self.buffers.items():
                buf.copy_(self._staging[k], non_blocking=True)
            self._copied.record()

    def __call__(self, params, caches, batch, index, valid=None,
                 block_tables=None):
        """``valid``: the valid counts, or for the draft step the caps."""
        self._check(params, caches)
        self._stage(batch, index, valid, block_tables)
        if self.graph is None:
            return self.run(), caches
        self.graph.replay()
        self.replays += 1
        _add_counts(self.launches)
        return self.logits, caches


def _graph(steps, backend):
    """Warm every step's body up with one split-K workspace, freeze it and
    capture each step as a CUDA graph, in order (on a CUDA device with the
    kernels; otherwise the steps stay eager).  The workspace is shared:
    the graphs replay in turn on one stream, as eager launches in turn
    share the per-stream one."""
    dev = steps[0].device
    if plan_lib.resolve_backend(backend, dev) != "cuda":
        return
    ws = ulppack_matmul.Workspace(dev)
    for step in steps:
        step.workspace = ws                 # the graphs replay its pointers
    with ulppack_matmul.workspace_scope(ws):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for step in (*steps, *steps):
                step.run()
        torch.cuda.current_stream(dev).wait_stream(side)
        ws.frozen = True
        for step in steps:
            step.capture()


def graphed_serving_steps(cfg, params, caches, *, batch: int,
                          prefill_chunk: int,
                          block_table_width: int | None = None,
                          backend: str = "auto", capture: bool = True):
    """``(decode_step, prefill_chunk_step)`` over static buffers for
    ``batch`` slots, bound to ``params`` and ``caches`` (paged pools when
    ``block_table_width`` is given), with the eager steps' call signature.

    On a CUDA device with the kernels (backend 'auto' or 'cuda'), each body
    is warmed up with every row dead -- no cache write, no recurrent state
    advanced, the attention kernels return zeros -- so every lazy step
    (library builds, shared-memory attributes, plans, the split-K
    workspace, which the pair owns) happens outside capture; then both are captured as CUDA graphs, the
    decode step first.  A failed capture raises.  On the CPU, or when the
    caller asked for the plain versions (backend 'torch', which holds
    host syncs), the same objects run their bodies eagerly; so they do
    with ``capture=False`` (a tensor-parallel engine whose shards sit on
    distinct cards: one graph does not span devices)."""
    kw = dict(batch=batch, block_table_width=block_table_width,
              backend=backend)
    dec = StaticStep(cfg, params, caches, kind="decode", width=1, **kw)
    pre = StaticStep(cfg, params, caches, kind="prefill_chunk",
                     width=prefill_chunk, **kw)
    if capture:
        _graph((dec, pre), backend)
    return dec, pre


def graphed_speculative_steps(cfg, params, caches, draft_cfg, draft_params,
                              draft_caches, *, k: int, batch: int,
                              prefill_chunk: int,
                              block_table_width: int | None = None,
                              draft_block_table_width: int | None = None,
                              backend: str = "auto",
                              capture: bool = True) -> dict:
    """Every step of a speculative engine over static buffers: the
    target's ``decode`` and ``prefill_chunk`` (as
    :func:`graphed_serving_steps`) and ``verify`` (a [batch, k + 1]
    window, all its logits), over ``params`` / ``caches``; the draft's
    ``draft_prefill`` (the ordinary prefill-chunk step) and ``draft`` (k
    drafts in one step, :func:`make_draft_step`), over ``draft_params`` /
    ``draft_caches`` of ``draft_cfg`` -- the counterpart of the reference's
    ``jitted_speculative_steps`` plus its serving steps.  On the card all
    five bodies warm up with one split-K workspace, frozen before the
    first capture, and are captured as CUDA graphs; a failed capture
    raises.  On the CPU, or on the 'torch' backend, they run eagerly; so
    they do with ``capture=False`` (shards on distinct cards).  Sharded
    params and caches (serve/shard.ShardPlan) are the target's and the
    draft's alike."""
    kw = dict(batch=batch, backend=backend)
    tkw = dict(kw, block_table_width=block_table_width)
    dkw = dict(kw, block_table_width=draft_block_table_width)
    steps = {
        "decode": StaticStep(cfg, params, caches, kind="decode", width=1,
                             **tkw),
        "prefill_chunk": StaticStep(cfg, params, caches,
                                    kind="prefill_chunk",
                                    width=prefill_chunk, **tkw),
        "verify": StaticStep(cfg, params, caches, kind="verify",
                             width=k + 1, **tkw),
        "draft_prefill": StaticStep(draft_cfg, draft_params, draft_caches,
                                    kind="prefill_chunk",
                                    width=prefill_chunk, **dkw),
        "draft": StaticStep(draft_cfg, draft_params, draft_caches,
                            kind="draft", width=1, k=k, **dkw)}
    if capture:
        _graph(tuple(steps.values()), backend)
    return steps
