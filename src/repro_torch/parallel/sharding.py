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
``models/attention.attention_apply``) and joins the results on the home
device (the mesh row's first); a leaf left whole lives once, on the home
device, and is computed once.

The training rules (``_RULES``, ``param_pspec``, the optimizer-state,
batch and activation constraints) belong to the multi-GPU training slice
(ROADMAP.md item 16).  Recurrent states stay whole here; the reference
splits their channel dimensions (ROADMAP.md item 14b).
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


def parts(leaf) -> tuple:
    """A leaf's per-shard tensors: a :class:`Sharded` leaf's parts, or the
    leaf itself as the one part."""
    return leaf.parts if isinstance(leaf, Sharded) else (leaf,)


def whole(leaf, device=None):
    """The whole tensor of a leaf (a :class:`Sharded` joined on
    ``device``; anything else as it is)."""
    return leaf.whole(device) if isinstance(leaf, Sharded) else leaf


def whole_tree(tree, device=None):
    """``tree`` with every :class:`Sharded` leaf joined (checkpoints and
    exported states hold whole tensors)."""
    if isinstance(tree, Sharded):
        return tree.whole(device)
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
    when the shard sits on the home device), anything else as it is."""
    dev = shard_device(node, i)
    return {k: v.parts[i] if isinstance(v, Sharded)
            else v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in node.items()}


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
    axis.  Recurrent states and an encoder-decoder's cross K/V stay
    whole."""
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
