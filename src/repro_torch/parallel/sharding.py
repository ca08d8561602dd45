"""Serving sharding rules: which axis of which leaf splits over the
tensor-parallel ``'model'`` axis (counterpart of the serving half of
``repro/parallel/sharding.py``).

A spec is a tuple with one entry per dimension of the leaf, ``'model'``
where that dimension is split over the mesh's ``model`` axis and None
where it is whole -- the counterpart of a ``PartitionSpec``, and equal to
the reference's spec as a tuple wherever the two packages agree.  Every
rule is divisibility-guarded (:func:`_guard`): an axis that does not divide
its dimension is dropped and the leaf stays whole, so a one-shard mesh --
or a tensor that cannot split -- degrades to the single-device layout.

A placed leaf whose spec names ``'model'`` is a :class:`Sharded`: one part
per shard, each a contiguous tensor on its shard's device.  The model code
computes on the parts shard by shard (``models/common.dense_apply``,
``models/attention.attention_apply``, ``models/mamba.mamba_apply``,
``models/xlstm.mlstm_apply`` / ``slstm_apply``) and joins the results on
the home device (the mesh row's first); a leaf left whole lives once, on
the home device, and is computed once.  A whole per-channel param of a
recurrent block (:data:`CHANNEL_LEAVES`) is a :class:`Mirrored`: the
channel-split states' shards each read their slice of it.

The training rules (the reference's ``_RULES``: FSDP over ``('data',)``
or ``('pod', 'data')``, Megatron column / row pairs over ``'model'``,
expert parallelism where the experts divide the axis) give every leaf of a
parameter, optimizer-state or batch tree its spec (:func:`param_pspec`,
:func:`param_shardings`, :func:`opt_state_shardings`,
:func:`batch_shardings`, :func:`cache_shardings`'s training branches); a
mesh there is anything with a ``.shape`` dict of axis sizes, such as
``launch/mesh.make_production_mesh``'s.  A spec entry naming several axes
is a tuple of them, and a tuple of one axis is that axis, as a
``PartitionSpec`` holds it.  The dry run (``launch/dryrun.py``) places by
these specs and :func:`shard_shape` gives a leaf's shape on one device.
:func:`constrain` and :func:`constrain_like_params` are hints to a
partitioner the port does not have: they return their input.
"""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import torch

MODEL = "model"

#: Open :func:`roofline.analysis.join_bytes` counters: every join of more
#: than one shard adds its per-device operand bytes to each.
JOIN_COUNTERS: list = []


def _count_join(kind: str, outs) -> None:
    if not JOIN_COUNTERS:
        return
    n = sum(t.numel() * t.element_size() for t in outs) // len(outs)
    for c in JOIN_COUNTERS:
        c[kind] += n
        c["counts"][kind] += 1


class Sharded:
    """One leaf split along ``axis`` over the ``model`` shards: ``parts[i]``
    is shard i's slice (contiguous, on shard i's device).  ``shape``,
    ``dtype`` and ``device`` describe the whole leaf as code that only
    reads metadata expects them (the shape is the global one, the device
    the first shard's)."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts, axis: int):
        self.parts = tuple(parts)
        self.axis = axis

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def dim(self) -> int:
        return self.parts[0].dim()

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts)

    def whole(self, device=None) -> torch.Tensor:
        """The parts joined into one tensor on ``device`` (the first
        shard's by default)."""
        dev = self.device if device is None else device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.axis)

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, axis="
                f"{self.axis}, {len(self.parts)} parts)")


#: The tolerance a block over channel-split states is held to against one
#: shard, relative to the largest magnitude of the compared tensor.  The
#: mLSTM's ``q . C`` and ``q . n`` sum over the split key axis as per-shard
#: partial sums, in another order than one shard's contraction, and the
#: sLSTM's per-shard columns of ``h @ r_gates`` may be reduced in another
#: blocking.  Mamba's per-channel work reduces only over unsplit axes and
#: is bit-equal on the CPU; on the card cuBLAS picks the kernel of
#: ``dt_proj``'s f32 product by shape, and at a shard's width it rounds
#: the last bit differently from the whole width's (the conv's contraction
#: stays bit-equal: ``chip_smoke.py``'s ``mamba_probe``).
CHANNEL_SPLIT_RTOL = 1e-5

#: The whole per-channel params of the recurrent blocks, by name: the axis
#: of their channels (``r_gates`` [NH, hd, 4 hd]: axis 3 of its [NH, hd, 4,
#: hd] view, each gate block's channels).  Their specs keep them whole, as
#: the reference's do; a shard of a channel-split state reads its slice.
CHANNEL_LEAVES = {"conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0,
                  "r_gates": 3}
_CHANNEL_PATHS = re.compile(r"/(mamba/(conv_w|conv_b|A_log|D)|"
                            r"slstm/r_gates)$")


def channel_slice(name: str, leaf: torch.Tensor, i: int, n: int):
    """Shard ``i`` of ``n``'s channels of the whole per-channel param
    ``name`` (:data:`CHANNEL_LEAVES`), a view."""
    if name == "r_gates":
        nh, hd, _ = leaf.shape
        leaf = leaf.view(nh, hd, 4, hd)
    axis = CHANNEL_LEAVES[name]
    w = leaf.shape[axis] // n
    return leaf.narrow(axis, i * w, w)


class Mirrored:
    """A whole per-channel param (:data:`CHANNEL_LEAVES`) of a layer whose
    states split by channel: ``whole`` lives on the home device, and
    ``parts[i]`` is the copy of shard i's channel slice on shard i's
    device, made once at placement -- None for a shard on the home
    device, which reads a view of ``whole`` (:func:`channel_part`)."""

    __slots__ = ("name", "whole", "parts")

    def __init__(self, name: str, whole: torch.Tensor, devices):
        self.name, self.whole = name, whole
        n = len(devices)
        self.parts = tuple(
            None if d == whole.device else
            channel_slice(name, whole, i, n).contiguous().to(d)
            for i, d in enumerate(devices))

    def nbytes(self) -> int:
        """The whole leaf's bytes and its copies'."""
        return sum(t.numel() * t.element_size()
                   for t in (self.whole, *self.parts) if t is not None)

    def __repr__(self):
        return (f"Mirrored({self.name}, {tuple(self.whole.shape)}, "
                f"{len(self.parts)} shards)")


def mirror(path: str, leaf: torch.Tensor, devices):
    """``leaf`` as a :class:`Mirrored` when ``path`` names a whole
    per-channel param of a recurrent block and its channels divide over
    the shards (as its block's states then do); else ``leaf``."""
    m = _CHANNEL_PATHS.search(path)
    n = len(devices)
    if m is None or n == 1:
        return leaf
    name = m.group(2) or "r_gates"
    axis = CHANNEL_LEAVES[name]
    channels = leaf.shape[1] if name == "r_gates" else leaf.shape[axis]
    return Mirrored(name, leaf, devices) if channels % n == 0 else leaf


def channel_part(node: dict, name: str, i: int, n: int, device):
    """Shard ``i`` of ``n``'s channel slice of the per-channel param
    ``node[name]`` on ``device``: a :class:`Mirrored`'s copy, else a view
    of the whole leaf (moved when it lies elsewhere)."""
    leaf = node[name]
    if isinstance(leaf, Mirrored):
        if leaf.parts[i] is not None:
            return leaf.parts[i]
        leaf = leaf.whole
    return channel_slice(name, leaf, i, n).to(device)


def parts(leaf) -> tuple:
    """A leaf's per-shard tensors: a :class:`Sharded` leaf's parts, or the
    leaf itself as the one part."""
    return leaf.parts if isinstance(leaf, Sharded) else (leaf,)


def whole(leaf, device=None):
    """The whole tensor of a leaf (a :class:`Sharded` joined on
    ``device``, a :class:`Mirrored`'s whole leaf; anything else as it
    is)."""
    if isinstance(leaf, Mirrored):
        return leaf.whole
    return leaf.whole(device) if isinstance(leaf, Sharded) else leaf


def whole_tree(tree, device=None):
    """``tree`` with every :class:`Sharded` leaf joined and every
    :class:`Mirrored` its whole leaf (checkpoints and exported states hold
    whole tensors)."""
    if isinstance(tree, (Sharded, Mirrored)):
        return whole(tree, device)
    if isinstance(tree, dict):
        return {k: whole_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole_tree(v, device) for v in tree]
    if isinstance(tree, tuple):
        return tuple(whole_tree(v, device) for v in tree)
    return tree


def copy_into(dst, src: torch.Tensor):
    """Copy the whole tensor ``src`` into the leaf ``dst`` in place: each
    part of a :class:`Sharded` takes its slice, so every part keeps its
    address."""
    if not isinstance(dst, Sharded):
        dst.copy_(src.to(dst))
        return
    start = 0
    for p in dst.parts:
        n = p.shape[dst.axis]
        p.copy_(src.narrow(dst.axis, start, n).to(p))
        start += n


def num_shards(node) -> int:
    """The shard count of the first :class:`Sharded` value of a layer's
    dict (0 when every value is whole)."""
    return next((len(v.parts) for v in node.values()
                 if isinstance(v, Sharded)), 0)


def shard_device(node: dict, i: int) -> torch.device:
    """Shard ``i``'s device, read off a layer dict's first
    :class:`Sharded` value."""
    return next(v.parts[i].device for v in node.values()
                if isinstance(v, Sharded))


def local(node: dict, i: int) -> dict:
    """Shard ``i``'s view of a layer's dict: each :class:`Sharded` value
    its part ``i``, each whole tensor moved to that part's device (a no-op
    when the shard sits on the home device), anything else as it is.  A
    dict with no :class:`Sharded` value is its own one shard."""
    if not num_shards(node):
        return node
    dev = shard_device(node, i)
    return {k: v.parts[i] if isinstance(v, Sharded)
            else v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in node.items()}


def join(outs, device, dim: int = -1) -> torch.Tensor:
    """The shards' results ``outs`` joined along ``dim`` on ``device`` (one
    shard's result only moved), in a ``shard_join`` profiler range."""
    if len(outs) == 1:
        return outs[0].to(device)
    _count_join("all-gather", outs)
    with torch.profiler.record_function("shard_join"):
        return torch.cat([t.to(device) for t in outs], dim=dim)


def add_up(outs, device) -> torch.Tensor:
    """The shards' partial sums ``outs`` added on ``device`` in shard order
    (one shard's sum only moved), in a ``shard_join`` profiler range."""
    if len(outs) == 1:
        return outs[0].to(device)
    _count_join("all-reduce", outs)
    with torch.profiler.record_function("shard_join"):
        total = outs[0].to(device)
        for t in outs[1:]:
            total = total + t.to(device)
        return total


def split(leaf: torch.Tensor, spec, devices) -> torch.Tensor | Sharded:
    """Place ``leaf`` by ``spec``: whole (on ``devices[0]``) when the spec
    names no axis or there is one device, else a :class:`Sharded` of
    ``len(devices)`` contiguous equal slices along the ``'model'`` axis,
    slice i on ``devices[i]``."""
    if MODEL not in spec or len(devices) == 1:
        return leaf.to(devices[0])
    axis = spec.index(MODEL)
    n = leaf.shape[axis] // len(devices)
    return Sharded([leaf.narrow(axis, i * n, n).contiguous().to(d)
                    for i, d in enumerate(devices)], axis)


def path_str(path) -> str:
    """A tree path ('/'-joined dict keys and list indices) as the
    reference's ``path_str`` writes it."""
    return "/".join(str(e) for e in path)


def map_with_path(fn, tree, path=()):
    """``tree`` with ``fn(path_str(path), leaf)`` at every leaf: dicts,
    lists and tuples are nodes, a None leaf stays None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return None if tree is None else fn(path_str(path), tree)


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's (a :class:`Sharded`'s global one), or
    numpy's for anything else (a Python scalar is 0-d)."""
    shape = getattr(leaf, "shape", None)
    return tuple(np.shape(leaf) if shape is None else shape)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _entry(axis):
    """A spec entry as a ``PartitionSpec`` holds it: a tuple of one axis
    is that axis, an empty one None."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


def _guard(mesh, shape, spec) -> tuple:
    """Drop the axes that do not divide their dimension (of a compound
    entry, keep its first axis that divides alone): the spec padded to the
    leaf's rank with None."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is None:
            out.append(None)
        elif dim % _axis_size(mesh, axis) == 0:
            out.append(_entry(axis))
        elif isinstance(axis, (tuple, list)):
            kept = [a for a in axis if dim % mesh.shape[a] == 0]
            out.append(kept[0] if kept else None)
        else:
            out.append(None)
    return tuple(out)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a leaf of ``shape`` placed by the
    (guarded) ``spec`` over ``mesh``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, a) for d, a in zip(shape, spec))


# ---------------------------------------------------------------------------
# Activation hints.  The reference calls constrain() where SPMD propagation
# needs help, inside an activation_mesh; the port has no partitioner, so
# the context announces nothing and both hints return their input.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def activation_mesh(mesh):
    """The reference's context announcing the mesh to ``constrain``."""
    yield mesh


def constrain(x, *axes):
    """The reference's sharding constraint on an activation; a hint the
    port has no partitioner for, so ``x`` itself."""
    return x


def constrain_like_params(tree, cfg):
    """The reference's constraint of a param-shaped tree (gradients,
    accumulators) to the param rules; ``tree`` itself."""
    return tree


# (regex, spec factory(fsdp, tp, ep)) — first match wins.
_RULES = [
    # packed serving weights (same layout roles as their kernels)
    (r"(o|down|out_proj|ffn_down)/col_sums$", lambda f, t, e: (None,)),
    (r"col_sums$",               lambda f, t, e: (t,)),
    (r"(w_scale|a_scale|w_zp|a_zp)$", lambda f, t, e: ()),
    (r"lm_head/kernel$",         lambda f, t, e: (f, t)),
    (r"frontend_proj/kernel$",   lambda f, t, e: (None, f)),
    # MoE experts [E, din, dout]
    (r"moe/(up|gate)/kernel$",
     lambda f, t, e: (t, f, None) if e else (None, f, t)),
    (r"moe/down/kernel$",
     lambda f, t, e: (t, None, f) if e else (None, t, f)),
    (r"moe/(up|gate|down)/(w_step|a_step)$", lambda f, t, e: ()),
    (r"moe/router/kernel$",      lambda f, t, e: (None, None)),
    # column-parallel projections [din, dout]
    (r"(attn|cross)/(q|k|v)/kernel$", lambda f, t, e: (f, t)),
    (r"(attn|cross)/(q|k|v)/bias$",   lambda f, t, e: (t,)),
    (r"(mlp|moe)?/?(up|gate)/kernel$", lambda f, t, e: (f, t)),
    (r"(in_proj|w_gates|ffn_up|up|gate|q|k|v)/kernel$",
     lambda f, t, e: (f, t)),
    (r"(in_proj|w_gates|ffn_up|up|gate)/bias$", lambda f, t, e: (t,)),
    # row-parallel projections [dout_tp, d]
    (r"(o|down|out_proj|ffn_down)/kernel$", lambda f, t, e: (t, f)),
    (r"(o|down|out_proj|ffn_down)/bias$",   lambda f, t, e: (None,)),
    # mamba internals
    (r"conv_w$",                 lambda f, t, e: (None, t)),
    (r"(conv_b|D)$",             lambda f, t, e: (t,)),
    (r"A_log$",                  lambda f, t, e: (t, None)),
    (r"x_proj/kernel$",          lambda f, t, e: (t, None)),
    (r"dt_proj/kernel$",         lambda f, t, e: (None, t)),
    (r"dt_proj/bias$",           lambda f, t, e: (t,)),
    # xLSTM gates
    (r"if_gate/kernel$",         lambda f, t, e: (t, None)),
    (r"if_gate/bias$",           lambda f, t, e: (None,)),
    (r"r_gates$",                lambda f, t, e: (None,)),
    # norms / steps / scalars / cnn
    (r"(norm\w*|final_norm)/(scale|bias)$", lambda f, t, e: (None,)),
    (r"(w_step|a_step|alpha)$",  lambda f, t, e: ()),
    (r"(stem|layers/\d+)/kernel$", lambda f, t, e: (None,)),
    (r"head/kernel$",            lambda f, t, e: (None, None)),
]


def _fsdp(cfg, mesh) -> tuple:
    return (("pod", "data") if (cfg.parallel.fsdp_over_pod
                                and "pod" in mesh.shape) else ("data",))


def param_pspec(path: str, leaf, cfg, mesh) -> tuple:
    """A training (or packed serving) param's spec by the reference's
    rules: the embedding by ``tie_embeddings``, then the first matching
    rule of :data:`_RULES`, else the largest dim over the FSDP axes; every
    entry divisibility-guarded."""
    fsdp = _fsdp(cfg, mesh)
    tp = MODEL
    ep = cfg.parallel.expert_parallel and \
        cfg.num_experts > 0 and cfg.num_experts % mesh.shape[tp] == 0
    shape = _shape(leaf)
    # packed weights take their kernel's rule
    path = re.sub(r"/w_packed$", "/kernel", path)
    # embedding: tied tables shard vocab over TP (logits matmul wants it);
    # untied tables shard d_model (gather-friendly, head handles logits)
    if re.search(r"embed/table$", path):
        spec = (tp, None) if cfg.tie_embeddings else (tp, fsdp)
        return _guard(mesh, shape, spec)
    for pat, fac in _RULES:
        if re.search(pat, path):
            return _guard(mesh, shape, fac(fsdp, tp, ep))
    # default: shard the largest dim over FSDP if divisible
    if not shape:
        return ()
    spec = [None] * len(shape)
    spec[int(np.argmax(shape))] = fsdp
    return _guard(mesh, shape, spec)


def param_shardings(params, cfg, mesh):
    """The specs of a param tree (real, ``meta`` or packed leaves), a tree
    of its structure."""
    return map_with_path(lambda p, leaf: param_pspec(p, leaf, cfg, mesh),
                         params)


def opt_state_shardings(opt_state, param_shardings_tree, cfg, mesh):
    """Optimizer moments take the parameter's spec; 8-bit moment blocks
    ([nblocks, block]) take FSDP on dim 0; the counter and scalars are
    whole."""
    fsdp = _fsdp(cfg, mesh)

    def one(ps, leaf):
        shape = _shape(leaf)
        if ps.endswith("count") or not shape:
            return ()
        if ps.endswith("/q") or ps.endswith("/scale"):
            return _guard(mesh, shape, (fsdp,) + (None,) * (len(shape) - 1))
        # fp32 moments: mirror the param rule by stripping the m/v prefix
        return param_pspec(re.sub(r"^(m|v)/", "", ps), leaf, cfg, mesh)

    return map_with_path(one, opt_state)


def batch_pspec(cfg, mesh, global_batch: int) -> tuple:
    """Leading batch-dim spec for inputs: ('pod', 'data') as far as they
    divide the batch.  An axis of size 1 splits nothing and is left out
    (the reference keeps it; both mean whole)."""
    keep, size = [], 1
    for a in ("pod", "data"):
        n = mesh.shape.get(a, 1)
        if n > 1 and global_batch % (size * n) == 0:
            keep.append(a)
            size *= n
    return (_entry(keep),)


def batch_shardings(batch, cfg, mesh, global_batch: int):
    """The specs of a batch dict: its leading (batch) dim by
    :func:`batch_pspec`; ``positions3`` [3, B, S] on its second."""
    bp = batch_pspec(cfg, mesh, global_batch)

    def one(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        if path.endswith("positions3"):
            return _guard(mesh, shape, (None, *bp))
        return _guard(mesh, shape, bp)

    return map_with_path(one, batch)


def cache_pspec(path: str, leaf, mesh, bp0=None, *,
                sequence_parallel: bool = False, kv_head_shard: bool = True,
                seq_shard: bool = False) -> tuple:
    """One cache leaf's spec (:func:`cache_shardings`); ``bp0`` is the
    batch axis's entry."""
    shape = _shape(leaf)
    if leaf is None or not shape:
        return ()
    if re.search(r"attn/(k_scale|v_scale)$", path):
        if kv_head_shard:
            return _guard(mesh, shape, (bp0, None, MODEL))
        return _guard(mesh, shape, (bp0, MODEL if seq_shard else None, None))
    if kv_head_shard and re.search(r"attn/(k|v)$", path):
        return _guard(mesh, shape, (bp0, None, MODEL, None))
    if re.search(r"attn/(k|v)$", path) or re.search(r"cross_kv", path):
        if seq_shard:
            seq_axes = ("data", MODEL) if sequence_parallel else MODEL
            return _guard(mesh, shape, (bp0, seq_axes, None, None))
        if sequence_parallel:
            return _guard(mesh, shape, (bp0, "data", None, MODEL))
        return _guard(mesh, shape, (bp0, None, None, MODEL))
    if path.endswith("mamba/conv"):
        return _guard(mesh, shape, (bp0, None, MODEL))
    if path.endswith("mamba/ssm"):
        return _guard(mesh, shape, (bp0, MODEL, None))
    if path.endswith("mlstm/C"):
        return _guard(mesh, shape, (bp0, None, MODEL, None))
    if path.endswith("mlstm/n") or re.search(r"slstm/(c|n|h|m)$", path):
        return _guard(mesh, shape, (bp0, None, MODEL))
    if path.endswith("mlstm/m"):
        return _guard(mesh, shape, (bp0, None))
    return _guard(mesh, shape, (bp0,))


def cache_shardings(caches, cfg, mesh, global_batch: int,
                    sequence_parallel: bool = False,
                    kv_head_shard: bool = False, paged: bool = False):
    """The specs of a cache list (``lm.init_caches``), a tree of the
    caches' structure, by the reference's rules.  The batch axis takes
    :func:`batch_pspec` (a page pool's page axis, which any slot's block
    table may point into, stays whole).

    ``kv_head_shard=True`` is the serving layout (serve/shard.ShardPlan):
    attention K/V split the kv-head axis (axis 2 of ``[B|P, S|page, KVH,
    hd|words]``) and the ``[B|P, S|page, KVH]`` scale planes follow it --
    exact at every ``kv_bits``, since quantization, word-packing, ring
    writes and the fused reads are per (position, kv head), so a head
    shard holds whole, locally decodable words.  Without it (the training
    layout of the dry run) K/V split head_dim over ``'model'``; with
    ``sequence_parallel`` (long_500k, batch 1) the sequence also splits
    over ``'data'``; ``REPRO_KV_SEQ_SHARD=1`` splits the sequence over
    ``'model'`` instead.  Recurrent states split their channels: mamba's
    ``conv`` [B, cw-1, di] on axis 2 and ``ssm`` [B, di, ds] on axis 1;
    the mLSTM's ``C`` [B, NH, hd, hd] and ``n`` [B, NH, hd] on axis 2 (the
    key dimension of the matrix memory); the sLSTM's ``c``, ``n``, ``h``
    and ``m`` [B, NH, hd] on axis 2.  The mLSTM's ``m`` [B, NH] stays
    whole, and an encoder-decoder's cross K/V follow the training K/V
    rule."""
    bp0 = None if paged else batch_pspec(cfg, mesh, global_batch)[0]
    seq_shard = os.environ.get("REPRO_KV_SEQ_SHARD", "0") == "1"
    return map_with_path(
        lambda p, leaf: cache_pspec(p, leaf, mesh, bp0,
                                    sequence_parallel=sequence_parallel,
                                    kv_head_shard=kv_head_shard,
                                    seq_shard=seq_shard), caches)


def place(tree, specs, devices):
    """``tree`` with each tensor placed by its spec in ``specs`` (a tree of
    the same structure, as :func:`cache_shardings` gives): :func:`split`
    over ``devices``; a None leaf stays None."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [place(v, sp, devices) for v, sp in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    return None if tree is None else split(tree, specs, devices)
