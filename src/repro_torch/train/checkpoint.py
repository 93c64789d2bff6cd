"""Checkpoints with atomic writes, retention and elastic restore, the port
of the reference's ``train/checkpoint.py``.

Layout: ``<dir>/step_<k>/arrays.npz`` + ``manifest.json``.  A state is a
nested dict (a module's ``state_dict()`` and the AdamW state, say) whose
leaves are tensors (of a type numpy holds) or Python numbers; leaves are
stored on the host by their key path (``params/layers.0.log_s``,
``opt/mu/...``, ``opt/step``) and restored by key into the structure,
devices and dtypes of a template.  Each
write goes to a temporary directory renamed into place, so a crash during a
write never spoils the latest checkpoint.

On a mesh (one process per rank, ``torch.distributed``) every rank holds the
whole replicated state: after a barrier rank 0 writes, and a second barrier
keeps the other ranks from reading before the write is whole.  The manifest
records the mesh as ``{"shape", "axis_names"}``; a restore onto another mesh
shape (an elastic restart) warns and carries on, as in the reference.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import comm


def _flatten(state, prefix: str = "") -> dict:
    """``{key path: leaf}`` of a nested dict."""
    out = {}
    for key, value in state.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = value
    return out


def mesh_meta(mesh) -> dict | None:
    """A mesh's shape and axis names as the manifest records them."""
    if mesh is None:
        return None
    return {"shape": [int(s) for s in mesh.shape], "axis_names": list(mesh.mesh_dim_names)}


def save(state, ckpt_dir: str, step: int, keep: int = 3, mesh=None) -> str:
    """Write ``state`` as step ``step`` and keep the last ``keep`` steps;
    ``mesh``, the mesh the state was trained on, goes into the manifest.
    With several processes every rank calls it and rank 0 writes.  Returns
    the checkpoint's directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    comm.barrier()
    if not dist.is_initialized() or dist.get_rank() == 0:
        _write(state, ckpt_dir, step, keep, final, mesh_meta(mesh))
    comm.barrier()
    return final


def _write(state, ckpt_dir, step, keep, final, mesh):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                  for k, v in _flatten(state).items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
            # the mesh this state was trained on: a restore onto another
            # warns (elastic restart) and never fails on it
            "mesh": mesh,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str | None) -> int | None:
    """The last step with a whole checkpoint under ``ckpt_dir``, or None."""
    if ckpt_dir is None or not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    valid = [d for d in steps if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    if not valid:
        return None
    return int(valid[-1].split("_")[1])


def restore(state_like, ckpt_dir: str, step: int | None = None, mesh=None):
    """``(state, step)``: the checkpoint (the latest by default) in the
    structure of ``state_like``, each tensor leaf on the device and in the
    dtype of its template, each number leaf of the template's type.  Raises
    on a missing leaf or a shape that differs.  ``mesh``: the mesh restored
    onto; one of another shape than the checkpoint's warns."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(path, "arrays.npz"))
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            saved_mesh = json.load(f).get("mesh")
    except (OSError, ValueError):
        saved_mesh = None
    new_mesh = mesh_meta(mesh)
    if saved_mesh and new_mesh and saved_mesh != new_mesh:
        warnings.warn(f"checkpoint step {step} was written under mesh {saved_mesh['shape']} "
                      f"{saved_mesh['axis_names']}; restoring onto {new_mesh['shape']} "
                      f"{new_mesh['axis_names']} (elastic restart)", stacklevel=2)

    def walk(like, prefix):
        out = {}
        for key, value in like.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                out[key] = walk(value, name + "/")
                continue
            if name not in data:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[name]
            if not isinstance(value, torch.Tensor):
                out[key] = type(value)(arr)
                continue
            if tuple(arr.shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(value.shape)}")
            out[key] = torch.from_numpy(np.array(arr)).to(value.device, value.dtype)
        return out

    return walk(state_like, ""), step
