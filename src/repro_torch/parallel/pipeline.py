"""GPipe-style pipeline parallelism over one axis of a mesh (counterpart of
``repro/parallel/pipeline.py``).

Stage ``s`` holds its slice of the stage params on device ``s`` of the
axis (``launch/mesh.axis_devices``; a device may repeat, so two stages can
share one card).  Schedule: the classic GPipe fill-drain over T = n_micro
+ n_stages - 1 ticks.  Stage s computes microbatch m at tick t = s + m, and
activations hop one stage a tick by ``.to()`` the next stage's device.
Bubble fraction = (P-1)/T, reported by :func:`bubble_fraction` so a caller
can size n_micro.  Every step is a differentiable tensor op, so autograd
runs the backward through the schedule.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _at(leaf, i, device=None):
    """Slice ``i`` of a stacked tensor leaf (on ``device`` when given); a
    non-tensor leaf (a packed layer's ``k_full``) is shared as it is."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    return leaf[i] if device is None else leaf[i].to(device)


def stack_stages(layers, n_stages: int):
    """``layers`` (a list of trees of one structure, as a model's blocks)
    as one tree whose tensor leaves are [n_stages, len(layers) / n_stages,
    ...]: stage s holds layers s * per .. (s + 1) * per - 1, in order.
    Non-tensor leaves must agree across layers and stay as they are."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not divide into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages

    def stack(*leaves):
        if not isinstance(leaves[0], torch.Tensor):
            if any(v != leaves[0] for v in leaves):
                raise ValueError("non-tensor leaves differ across layers")
            return leaves[0]
        return torch.stack(leaves).reshape(n_stages, per,
                                           *leaves[0].shape)

    return tree_lib.tree_map(stack, layers[0], *layers[1:])


def layer(stage_params, j: int):
    """Layer ``j`` of one stage's slice of :func:`stack_stages`'s tree."""
    return tree_lib.tree_map(lambda a: _at(a, j), stage_params)


def gpipe(stage_fn, stage_params, xs, *, mesh, axis: str = "pod"):
    """Run ``xs`` microbatches through a pipeline along ``axis``.

    stage_fn(params, x) -> y: one stage's computation; the activation
    shape is preserved across stages (transformer blocks).
    stage_params: tree whose tensor leaves have a leading stage dim == the
    axis size (stage s's slice is moved to stage s's device;
    :func:`stack_stages` builds one from a model's blocks).
    xs: [n_micro, mb, ...] microbatched inputs.
    Returns [n_micro, mb, ...] outputs on ``xs``'s device, collected from
    the last stage."""
    n_stages = mesh.shape[axis]
    n_micro = xs.shape[0]
    devs = mesh_lib.axis_devices(mesh, axis)
    home = xs.device
    params = [tree_lib.tree_map(lambda a, s=s: _at(a, s, devs[s]),
                                stage_params) for s in range(n_stages)]
    buf = [None] * n_stages          # the activation arriving at stage s
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        ys = {}
        for s in range(n_stages):
            if 0 <= t - s < n_micro:
                # stage 0 injects microbatch t while the pipe fills
                x = xs[t].to(devs[0]) if s == 0 else buf[s]
                ys[s] = stage_fn(params[s], x)
        last = n_stages - 1
        if last in ys:               # the last stage collects t - (P-1)
            outs[t - last] = ys[last].to(home)
        # hop activations one stage forward
        buf = [None] + [ys[s].to(devs[s + 1]) if s in ys else None
                        for s in range(n_stages - 1)]
    return torch.stack(outs)
