"""Parameter and train-state trees across packages: numpy trees <-> the
port's tensors.

``from_repro`` takes a reference tree as ``jax.device_get`` returns it --
nested dicts / lists / tuples of numpy arrays and Python scalars -- and
returns the same tree of torch tensors on ``device``: parameter trees
(which the port then packs itself, serve/prepare.py) and whole train
states alike (params, the optimizer state with its 8-bit moment dicts
``{"q": int8, "scale": f32}``, the int32 0-d ``count`` and ``step``).
``to_repro`` goes back with every dtype kept, so one state can start both
packages' train steps.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects; they cross as their raw 16-bit patterns
(``.view(np.uint16)`` -> ``torch.uint16`` -> ``.view(torch.bfloat16)``), so
every bit is kept.  ``to_numpy`` goes the other way with bf16 widened to
float32, which is exact; ``to_repro`` returns bf16 leaves as
``ml_dtypes.bfloat16`` arrays (the reference's host dtype; ml_dtypes is
imported only there, where the reference package is installed).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import plan as plan_lib


def _leaf_to_tensor(x, device) -> torch.Tensor:
    arr = np.array(x)        # a writable copy (device_get's may be read-only)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_repro(tree, device="cuda"):
    """numpy tree (``jax.device_get`` of a reference tree) -> tensors on
    ``device``.  Python ints/floats/bools stay Python scalars (e.g. the
    packed trees' ``k_full``)."""
    dev = plan_lib.resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        return _leaf_to_tensor(node, dev)

    return walk(tree)


def to_numpy(tree):
    """Tensor tree -> numpy tree on the host (bf16 widened to float32)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            return t.numpy()
        return node

    return walk(tree)


def to_repro(tree):
    """Tensor tree -> numpy tree on the host with every dtype kept (bf16
    as ``ml_dtypes.bfloat16``, bit for bit), ready for
    ``jax.tree.map(jnp.asarray, ...)``."""
    import ml_dtypes

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            if t.dtype == torch.bfloat16:
                return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            return t.numpy()
        return node

    return walk(tree)
