"""Serving ShardPlan: the tensor-parallel layout of packed inference
(counterpart of ``repro/serve/shard.py``).

Given a one-row serving mesh (launch/mesh.ServingMesh), a
:class:`ShardPlan` says for every leaf of the packed serving tree and of
the decode caches which axis splits over the ``model`` shards, and places
each split leaf as a ``parallel.sharding.Sharded`` -- one contiguous slice
per shard, on that shard's device.

The layout keeps sub-byte packing exact under sharding:

* **Packed weights split their output (N) axis**: every packed Dense is
  column-parallel.  Lanes and bit-dense words pack along the contraction
  (K) axis, which stays whole, so a word or lane never straddles a shard
  and each shard's K2 launch is the ``[rows, Kp] x [Kp, N / tp]`` product
  of its own columns.  The activations' quantize-and-pack uses scalar
  scales over the whole K, so every shard quantizes them identically.
* ``col_sums`` / ``bias`` ([N]) split with their columns; the quant
  scalars, the MoE router's kernel (routing needs every expert's logit;
  the reference splits it), and every other leaf (embedding tables,
  norms, 3-D MoE experts), stay whole.
* **KV caches split the kv-head axis** (parallel/sharding.cache_shardings):
  quantization, word-packing, writes and fused reads are per (position,
  kv head), so each shard's window write and K3 / K4 read cover its own
  ``KVH / tp`` kv heads and the ``H / tp`` query heads that use them.
* **Recurrent states split their channels** (mamba's ``di``, the mLSTM's
  and the sLSTM's head dimension): each shard runs the per-channel work
  of its slice in place, and a whole per-channel param (the conv, ``A_log``,
  ``D``, the sLSTM's ``r_gates``) is a ``sharding.Mirrored`` whose slice
  the shard reads -- a view on the home device, a copy made here on any
  other.

Every rule is divisibility-guarded: a dimension the shard count does not
divide stays whole, and a one-shard mesh is the single-device layout.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding as sharding_lib

#: Packed-Dense leaf names whose trailing axis is the output (N) axis.
_COLUMN_LEAVES = re.compile(r"/(w_packed|w_dense|kernel)$")
_VECTOR_LEAVES = re.compile(r"/(col_sums|bias)$")
_SCALAR_LEAVES = re.compile(r"/(w_scale|a_scale|w_zp|a_zp|k_full|w_step|"
                            r"a_step)$")
#: The MoE router's [d, E] kernel: routing reads every expert's logit, so no
#: shard computes on a part of it and it stays whole (the reference splits
#: it by columns and gathers it again).
_WHOLE_LEAVES = re.compile(r"/router/kernel$")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Frozen description of how one serving replica lays tensors out over
    its mesh row.  ``axis`` is the tensor-parallel axis name.  Building a
    plan touches no tensor; :meth:`place_params` / :meth:`place_caches`
    split the leaves, once, at engine init."""

    mesh: object
    axis: str = "model"

    @property
    def model_shards(self) -> int:
        return int(self.mesh.shape.get(self.axis, 1))

    @property
    def devices(self) -> tuple:
        """The shards' devices (the mesh's one row); the first is home."""
        return self.mesh.devices[0]

    def shards_of(self, n: int) -> int:
        """How many ways a dimension of ``n`` splits (1 when indivisible)."""
        s = self.model_shards
        return s if s > 0 and n % s == 0 else 1

    def local_out(self, n: int) -> int:
        """A shard's width of an output dimension of global ``n``: what
        serve/prepare.build_layer_plans plans, so the plans and their
        tuning-cache keys describe what one shard launches."""
        return n // self.shards_of(n)

    # ------------------------------------------------------------------
    # Params (the packed serving tree)
    # ------------------------------------------------------------------

    def param_pspec(self, path: str, leaf) -> tuple:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or _SCALAR_LEAVES.search(path):
            return ()
        if _WHOLE_LEAVES.search(path):
            return (None,) * len(shape)
        if _VECTOR_LEAVES.search(path) and len(shape) == 1:
            return self._guard(shape, (self.axis,))
        if _COLUMN_LEAVES.search(path) and len(shape) == 2:
            # [Kp|Kw|K, N]: split the columns; K, where the lanes and words
            # pack, stays whole, so word boundaries are shard-local
            return self._guard(shape, (None, self.axis))
        return (None,) * len(shape)

    def place_params(self, params):
        """``params`` with every split leaf a ``Sharded`` over the shards'
        devices, every whole tensor on the home device, and each whole
        per-channel param of a channel-split recurrent block a
        ``Mirrored`` (its slices copied to the shards off the home
        device)."""
        def one(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            placed = sharding_lib.split(
                leaf, self.param_pspec(f"/{path}", leaf), self.devices)
            if isinstance(placed, torch.Tensor):
                placed = sharding_lib.mirror(f"/{path}", placed,
                                             self.devices)
            return placed
        return sharding_lib.map_with_path(one, params)

    def shard_param_bytes(self, params) -> dict:
        """Serving-param bytes by shard: ``split`` -- each shard's slices of
        the split leaves and its copies of ``Mirrored`` slices; ``whole``
        -- the leaves left whole; ``per_shard`` -- what each shard would
        hold on a device of its own (its slices plus the whole leaves)."""
        split, rest = [0] * self.model_shards, 0
        for leaf in tree_lib.leaves(params):
            if isinstance(leaf, sharding_lib.Mirrored):
                rest += leaf.whole.numel() * leaf.whole.element_size()
                for i, p in enumerate(leaf.parts):
                    if p is not None:
                        split[i] += p.numel() * p.element_size()
            elif isinstance(leaf, sharding_lib.Sharded):
                for i, p in enumerate(leaf.parts):
                    split[i] += p.numel() * p.element_size()
            elif isinstance(leaf, torch.Tensor):
                rest += leaf.numel() * leaf.element_size()
        return {"split": split, "whole": rest,
                "per_shard": [s + rest for s in split]}

    # ------------------------------------------------------------------
    # Caches (the kv-head axis, every kv_bits layout)
    # ------------------------------------------------------------------

    def place_caches(self, caches):
        """``caches`` with the kv-head-split and channel-split leaves
        ``Sharded`` (a page pool's too: its page axis stays whole)."""
        return sharding_lib.place(
            caches, sharding_lib.cache_shardings(
                caches, None, self.mesh, 1, kv_head_shard=True),
            self.devices)

    def shard_state_bytes(self, caches, batch: int) -> dict:
        """A slot's recurrent-state bytes (``caches`` holds ``batch`` slot
        rows) by shard: ``split`` -- each shard's channel slices;
        ``whole`` -- the states left whole (the mLSTM's ``m``, and any
        whose channels do not divide), on the home device; ``per_shard``
        -- its slices plus the whole states; ``one_shard`` -- the
        unsplit total."""
        split, rest = [0] * self.model_shards, 0
        for layer in caches:
            for kind, sub in layer.items():
                if kind in ("attn", "cross_kv") or sub is None:
                    continue
                for leaf in sub.values():
                    if isinstance(leaf, sharding_lib.Sharded):
                        for i, p in enumerate(leaf.parts):
                            split[i] += p.numel() * p.element_size() // batch
                    else:
                        rest += leaf.numel() * leaf.element_size() // batch
        return {"split": split, "whole": rest,
                "per_shard": [s + rest for s in split],
                "one_shard": sum(split) + rest}

    # ------------------------------------------------------------------

    def _guard(self, shape, spec) -> tuple:
        return sharding_lib._guard(self.mesh, shape, spec)

    def describe(self) -> dict:
        """Flat report row (serve CLI, capacity report)."""
        return {"mesh": dict(self.mesh.shape), "tp_axis": self.axis,
                "model_shards": self.model_shards,
                "devices": [str(d) for d in self.devices]}
