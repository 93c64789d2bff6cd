"""Checkpoints with atomic writes and retention, the port of the reference's
``train/checkpoint.py`` on one device.

Layout: ``<dir>/step_<k>/arrays.npz`` + ``manifest.json``.  A state is a
nested dict (a module's ``state_dict()`` and the AdamW state, say) whose
leaves are tensors (of a type numpy holds) or Python numbers; leaves are
stored on the host by their key path (``params/layers.0.log_s``,
``opt/mu/...``, ``opt/step``) and restored by key into the structure,
devices and dtypes of a template.  Each
write goes to a temporary directory renamed into place, so a crash during a
write never spoils the latest checkpoint.  The mesh metadata of an elastic
restart comes with the distribution slice (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Mapping

import numpy as np
import torch


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


def save(state, ckpt_dir: str, step: int, keep: int = 3) -> str:
    """Write ``state`` as step ``step`` and keep the last ``keep`` steps.
    Returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
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
    return final


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


def restore(state_like, ckpt_dir: str, step: int | None = None):
    """``(state, step)``: the checkpoint (the latest by default) in the
    structure of ``state_like``, each tensor leaf on the device and in the
    dtype of its template, each number leaf of the template's type.  Raises
    on a missing leaf or a shape that differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))

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
