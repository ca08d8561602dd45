"""Meshes (counterpart of ``repro/launch/mesh.py``).

A :class:`ServingMesh` is a 2-D grid of ``torch.device`` with the axes
``('data', 'model')``: each row is one replica's tensor-parallel group
(serve/shard.ShardPlan splits over the row), and the rows are the replica
fleet behind serve/router.Router (:func:`replica_meshes`).  The caller may
list the devices explicitly, repeating one: ``ServingMesh([[cuda:0,
cuda:0]])`` runs two shards on one card, each launching its kernels at its
own shapes, and a mesh of ``cpu`` devices runs every sharded path on the
CPU.  :func:`make_host_mesh` and :func:`make_serving_mesh` build one from
the devices the host has, clamping a request it cannot meet, loudly.

A :class:`Mesh` is a grid of devices with any axis names: the pipeline
(``parallel/pipeline.gpipe``) runs over one axis of it, and
:func:`make_production_mesh` gives the reference's production meshes
without devices, for the dry run (``launch/dryrun.py``) to plan on.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from repro_torch.kernels import plan as plan_lib

AXES = ("data", "model")


class Mesh:
    """A grid of ``torch.device`` with named axes, like a JAX mesh:
    ``devices`` a nested list (or object array) whose nesting follows
    ``axis_names``, entries free to repeat (``Mesh([cuda:0, cuda:0],
    ("pod",))`` runs two pipeline stages on one card); or ``devices=None``
    with a ``shape`` tuple for a device-free mesh that rules and plans read
    only the ``shape`` dict of."""

    def __init__(self, devices, axis_names, shape=None):
        self.axis_names = tuple(axis_names)
        self.devices = None if devices is None else np.vectorize(
            torch.device, otypes=[object])(np.array(devices, dtype=object))
        dims = tuple(shape) if devices is None else self.devices.shape
        if len(dims) != len(self.axis_names):
            raise ValueError(f"mesh of shape {dims} for axes "
                             f"{self.axis_names}")
        self._dims = dims

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self) -> int:
        return math.prod(self._dims)

    def __repr__(self):
        return f"Mesh({self.shape})"


def axis_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` of a mesh (:class:`Mesh` or
    :class:`ServingMesh`), at index 0 of every other axis."""
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} has no devices to run on")
    arr = np.array(mesh.devices, dtype=object)
    arr = np.moveaxis(arr, list(mesh.axis_names).index(axis), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, device-free: 16x16 = 256 chips a
    pod over ``('data', 'model')``; multi-pod adds a leading 2-pod axis
    (512 chips, ``('pod', 'data', 'model')``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape=shape)


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
