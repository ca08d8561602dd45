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

The training rules (``_RULES``, ``param_pspec``, the optimizer-state,
batch and activation constraints) belong to the multi-GPU training slice
(ROADMAP.md item 16).
"""

from __future__ import annotations

import re

import torch

MODEL = "model"


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
    with torch.profiler.record_function("shard_join"):
        return torch.cat([t.to(device) for t in outs], dim=dim)


def add_up(outs, device) -> torch.Tensor:
    """The shards' partial sums ``outs`` added on ``device`` in shard order
    (one shard's sum only moved), in a ``shard_join`` profiler range."""
    if len(outs) == 1:
        return outs[0].to(device)
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


def _guard(mesh, shape, spec) -> tuple:
    """Drop the axes that do not divide their dimension: the spec padded
    to the leaf's rank with None."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(None if axis is None or dim % mesh.shape[axis] else axis
                 for dim, axis in zip(shape, spec))


def cache_pspec(path: str, leaf, mesh) -> tuple:
    """One cache leaf's serving-TP spec (:func:`cache_shardings`)."""
    if not isinstance(leaf, (torch.Tensor, Sharded)) or not leaf.dim():
        return ()
    shape = tuple(leaf.shape)
    if re.search(r"attn/(k_scale|v_scale)$", path):
        return _guard(mesh, shape, (None, None, MODEL))
    if re.search(r"attn/(k|v)$", path):
        return _guard(mesh, shape, (None, None, MODEL, None))
    if path.endswith("mamba/conv"):
        return _guard(mesh, shape, (None, None, MODEL))
    if path.endswith("mamba/ssm"):
        return _guard(mesh, shape, (None, MODEL, None))
    if path.endswith("mlstm/C"):
        return _guard(mesh, shape, (None, None, MODEL, None))
    if path.endswith("mlstm/n") or re.search(r"slstm/(c|n|h|m)$", path):
        return _guard(mesh, shape, (None, None, MODEL))
    return (None,) * len(shape)


def cache_shardings(caches, mesh):
    """The serving-TP specs of a cache list (``lm.init_caches``), a tree of
    the caches' structure: attention K/V split the kv-head axis (axis 2 of
    ``[B|P, S|page, KVH, hd|words]``) and the ``[B|P, S|page, KVH]`` scale
    planes follow it -- exact at every ``kv_bits``, since quantization,
    word-packing, ring writes and the fused reads are per (position, kv
    head), so a head shard holds whole, locally decodable words.  The batch
    axis (a page pool's page axis, which any slot's block table may point
    into) stays whole, as it does on the reference's one-row ``data``
    axis.  Recurrent states split their channels, as the reference's
    do: mamba's ``conv`` [B, cw-1, di] on axis 2 and ``ssm`` [B, di, ds]
    on axis 1; the mLSTM's ``C`` [B, NH, hd, hd] and ``n`` [B, NH, hd] on
    axis 2 (the key dimension of the matrix memory); the sLSTM's ``c``,
    ``n``, ``h`` and ``m`` [B, NH, hd] on axis 2.  The mLSTM's ``m`` [B,
    NH] and an encoder-decoder's cross K/V stay whole."""
    return map_with_path(lambda p, leaf: cache_pspec(p, leaf, mesh), caches)


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
