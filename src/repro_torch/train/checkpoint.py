"""Checkpoints in the reference's on-disk format (counterpart of
``repro/train/checkpoint.py``), so each package restores the other's:

  <dir>/step_<n>/manifest.json     -- step, one entry per leaf (name, file,
                                      dtype, shape), the tree structure
                                      (``PyTreeDef(...)``) and any extra
                                      keys (data state, config name)
  <dir>/step_<n>/arrays/<i:05d>.npy -- leaf i, in the reference's leaf
                                      order (dict keys sorted, list items
                                      in order; names '/'-joined)
  <dir>/step_<n>/COMMITTED         -- the commit marker; a save writes
                                      ``step_<n>.tmp`` and renames it into
                                      place, and readers ignore steps
                                      without the marker

bf16 leaves go through their raw bytes: numpy has no bfloat16 without
``ml_dtypes``, so they are written as 2-byte void arrays (``V2``, what
``np.save`` writes for the reference's ml_dtypes leaves) with manifest
dtype ``"bfloat16"``, and read back through uint16 -> ``torch.uint16`` ->
bf16.  Every bit is kept both ways.

``save`` snapshots the state to host memory before it returns (the
trainer's next step may free the tensors) and writes either at once or
on a background thread.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import plan as plan_lib


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype.kind == "V":
        raise ValueError(f"cannot read a {dtype} leaf stored as raw bytes")
    return torch.from_numpy(np.array(arr)).to(device)


def save(directory, state, *, step: int, extra: dict | None = None,
         async_: bool = False):
    """Checkpoint the tree ``state`` as step ``step``.  Returns a join()
    callable (a no-op after a synchronous save)."""
    directory = Path(directory)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    # snapshot to host memory now
    leaves = [(name, *_to_host(leaf))
              for name, leaf in tree_lib.flatten_with_path(state)]
    treedef = tree_lib.treedef_str(state)

    def write():
        arr_dir = tmp / "arrays"
        arr_dir.mkdir(exist_ok=True)
        names = []
        for i, (name, arr, dtype) in enumerate(leaves):
            fn = f"{i:05d}.npy"
            np.save(arr_dir / fn, arr)
            names.append({"name": name, "file": fn, "dtype": dtype,
                          "shape": list(arr.shape)})
        manifest = {"step": step, "leaves": names, "treedef": treedef,
                    **(extra or {})}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "COMMITTED").touch()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    if async_:
        th = threading.Thread(target=write, daemon=True)
        th.start()
        return th.join
    write()
    return lambda: None


def _committed_steps(directory: Path) -> list:
    if not directory.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in directory.iterdir()
                  if d.name.startswith("step_")
                  and not d.name.endswith(".tmp")
                  and (d / "COMMITTED").exists())


def latest_step(directory) -> int | None:
    steps = _committed_steps(Path(directory))
    return steps[-1] if steps else None


def restore(directory, state_template=None, *, step: int | None = None,
            device="cuda"):
    """Read a committed checkpoint into the structure of
    ``state_template`` (a tree whose leaves are ignored), or, without one,
    the structure the manifest records.  Each leaf's name must equal the
    template's path to it.  Leaves land on ``device``.  Returns (state,
    manifest)."""
    dev = plan_lib.resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    if state_template is None:
        state_template = tree_lib.template_from_treedef(manifest["treedef"])
    want = [name for name, _ in tree_lib.flatten_with_path(state_template)]
    got = [leaf["name"] for leaf in manifest["leaves"]]
    if want != got:
        raise ValueError(
            f"checkpoint has {len(got)} leaves, template expects "
            f"{len(want)}; first difference: "
            f"{next(((w, g) for w, g in zip(want, got) if w != g), None)} "
            f"-- config mismatch?")
    arrays = [_from_host(np.load(d / "arrays" / leaf["file"]),
                         leaf["dtype"], dev)
              for leaf in manifest["leaves"]]
    return tree_lib.unflatten(state_template, arrays), manifest


def garbage_collect(directory, keep: int = 3):
    """Delete all but the newest ``keep`` committed steps."""
    directory = Path(directory)
    for s in _committed_steps(directory)[:-keep]:
        shutil.rmtree(directory / f"step_{s}", ignore_errors=True)
