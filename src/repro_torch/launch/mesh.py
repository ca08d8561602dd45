"""Serving meshes (counterpart of ``repro/launch/mesh.py``'s serving half).

A :class:`ServingMesh` is a 2-D grid of ``torch.device`` with the axes
``('data', 'model')``: each row is one replica's tensor-parallel group
(serve/shard.ShardPlan splits over the row), and the rows are the replica
fleet behind serve/router.Router (:func:`replica_meshes`).  The caller may
list the devices explicitly, repeating one: ``ServingMesh([[cuda:0,
cuda:0]])`` runs two shards on one card, each launching its kernels at its
own shapes, and a mesh of ``cpu`` devices runs every sharded path on the
CPU.  :func:`make_host_mesh` and :func:`make_serving_mesh` build one from
the devices the host has, clamping a request it cannot meet, loudly.

The production TPU mesh of the reference belongs to the dry run
(ROADMAP.md item 16).
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.kernels import plan as plan_lib

AXES = ("data", "model")


class ServingMesh:
    """A ``('data', 'model')`` grid of devices: ``devices[r][m]`` is shard
    ``m`` of replica ``r``.  ``shape`` is a dict like a JAX mesh's."""

    axis_names = AXES

    def __init__(self, devices):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0]:
            raise ValueError("a serving mesh needs at least one device")
        if any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"serving mesh rows differ in length: "
                             f"{[len(r) for r in rows]}")
        self.devices = rows

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def __repr__(self):
        return f"ServingMesh({[[str(d) for d in r] for r in self.devices]})"


def _host_devices(device) -> list:
    dev = plan_lib.resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A mesh over the host's distinct devices of ``device``'s type (the
    cards, or the one CPU device), row-major.

    Both axes are validated (>= 1) and a request the host cannot meet is
    clamped to what it has, with a warning: a sharded run that silently
    served on a 1x1 mesh would test nothing."""
    if data < 1 or model < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got (data={data}, model={model})")
    devs = _host_devices(device)
    n = len(devs)
    data_actual = min(data, n)
    model_actual = min(model, max(1, n // data_actual))
    if (data_actual, model_actual) != (data, model):
        warnings.warn(
            f"make_host_mesh: requested (data={data}, model={model}) "
            f"needs {data * model} devices but the host has {n}; "
            f"clamping to (data={data_actual}, model={model_actual}). "
            f"List the devices explicitly (ServingMesh([[dev, dev]])) to "
            f"place several shards on one device.", stacklevel=2)
    return ServingMesh([devs[r * model_actual:(r + 1) * model_actual]
                        for r in range(data_actual)])


def make_serving_mesh(model: int = 1, data: int = 1, *, device="cuda"):
    """Serving mesh ``('data', 'model')``: ``model`` is one replica's
    tensor-parallel width (``--model-parallel``), ``data`` the replica
    count behind the Router (``--data-parallel``), validated and clamped
    to the host's devices by :func:`make_host_mesh`."""
    return make_host_mesh(data=data, model=model, device=device)


def replica_meshes(mesh):
    """One ``(1, model)`` mesh per data row: each replica's ShardPlan
    splits over its own row's devices."""
    if tuple(mesh.axis_names) != AXES:
        raise ValueError(
            f"expected a ('data', 'model') serving mesh, got axes "
            f"{tuple(mesh.axis_names)}")
    return [ServingMesh([row]) for row in mesh.devices]
