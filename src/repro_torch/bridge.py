"""Carry a parameter tree of the reference across into the port's modules.

``params_from_numpy(module, tree)`` loads the tree that the reference's
``init`` returns, with every leaf already a numpy array (the caller maps
``np.asarray`` over it), into ``module``:

* tuple index ``i`` maps to ``layers.{i}`` (a chain's layers; a list under a
  dict key, such as ``CouplingMLP``'s ``{"layers": [...]}``, to that
  ``nn.ModuleList``'s ``{key}.{i}``) and dict keys to attribute names, so
  ``state_dict()`` keys read like the tree's paths (``layers.2.layer.lu.l``;
  ``OnFirst`` adds ``layer.``, since the reference's ``OnFirst`` passes its
  layer's parameters through);
* a ``None`` leaf (a HINT identity leaf, ``{"leaf": None}``) holds no
  parameter and stays ``None``; a ``ConditionalFlow``'s ``{"summary",
  "flow"}`` maps onto its two submodules;
* integer leaves land in integer buffers and keep their dtype;
* it raises on a leaf left unmapped on either side, on a shape mismatch and on
  a float/integer mismatch.

``tree_to_numpy(module, like=tree, values=None)`` is the way back: the
module's leaves (or ``values``, such as the ``{name: grad}`` dict of
``core/autodiff.py::value_and_grad_nll``) in the layout of the reference's
tree ``like``, every leaf a numpy array.

Two trees carry across without a module of the reference's layout:

* ``torch_tree(tree)`` - a nested dict of numpy leaves as the same dict of
  tensors: the reference's stage-stacked pipeline parameters (``{"stages":
  {...: (S, L, ...)}, ...}``), which ``train_pipeline``'s ``init_fn``
  returns and ``ParamTree`` holds;
* ``named_from_numpy(module, tree)`` - a tree in the layout of ``module``'s
  reference tree, such as the error-feedback residuals of
  ``optim/compression.py::compression_init`` (with or without the leading
  shard axis a checkpoint gives them), as the port's ``{state key:
  tensor}`` dict, its ``None`` leaves left out.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.chain import OnFirst


def _map_tree(module, tree, fn):
    """``tree`` with each leaf replaced by ``fn(state_dict key, leaf)``;
    ``None`` leaves stay ``None``."""
    def walk(mod, sub, prefix):
        while isinstance(mod, OnFirst):
            mod, prefix = mod.layer, prefix + "layer."
        if isinstance(sub, (tuple, list)):
            seq, prefix = (mod, prefix) if isinstance(mod, nn.ModuleList) else (
                mod.layers, prefix + "layers.")
            return type(sub)(walk(seq[i], leaf, f"{prefix}{i}.") for i, leaf in enumerate(sub))
        if isinstance(sub, Mapping):
            out = {}
            for key, leaf in sub.items():
                if leaf is None:
                    out[key] = None
                    continue
                nested = isinstance(leaf, (Mapping, tuple, list))
                child = getattr(mod, key, None) if nested else mod
                if child is None:
                    raise KeyError(f"no submodule {prefix}{key} for the tree's {key!r}")
                out[key] = walk(child, leaf, f"{prefix}{key}." if nested else prefix + key)
            return out
        return fn(prefix, sub)

    return walk(module, tree, "")


def tree_paths(module, tree) -> dict[str, np.ndarray]:
    """``{state_dict key: leaf}`` for every leaf of ``tree`` laid over ``module``."""
    out: dict[str, np.ndarray] = {}
    _map_tree(module, tree, lambda key, leaf: out.__setitem__(key, np.asarray(leaf)))
    return out


def tree_to_numpy(module: torch.nn.Module, like, values=None):
    """``module``'s leaves, or ``values[key]`` for each state-dict key, as a
    tree shaped like the reference's ``like``, with numpy leaves.  Keys that
    ``values`` lacks (integer buffers have no gradient) come back as zeros of
    the leaf's shape and dtype in ``like``."""
    state = module.state_dict(keep_vars=True) if values is None else values

    def leaf(key, ref):
        v = state.get(key)
        if v is None:
            ref = np.asarray(ref)
            return np.zeros(ref.shape, ref.dtype)
        return v.detach().cpu().numpy()

    return _map_tree(module, like, leaf)


def params_from_numpy(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy ``tree``'s leaves into ``module``'s parameters and buffers in
    place; returns ``module``."""
    leaves = tree_paths(module, tree)
    state = module.state_dict(keep_vars=True)
    missing = sorted(set(state) - set(leaves))
    extra = sorted(set(leaves) - set(state))
    if missing or extra:
        raise KeyError(f"unmapped leaves: module-only {missing}, tree-only {extra}")
    with torch.no_grad():
        for key, arr in leaves.items():
            dst = state[key]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: tree shape {arr.shape} != module shape {tuple(dst.shape)}")
            if np.issubdtype(arr.dtype, np.floating) != dst.is_floating_point():
                raise TypeError(f"{key}: tree dtype {arr.dtype} vs module dtype {dst.dtype}")
            dst.copy_(torch.from_numpy(np.array(arr)).to(dst.dtype))
    return module


def torch_tree(tree):
    """A nested dict (or tuple) of numpy leaves as the same structure of
    tensors (copies)."""
    if isinstance(tree, Mapping):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def named_from_numpy(module: torch.nn.Module, tree) -> dict[str, torch.Tensor]:
    """``{state key: tensor}`` of ``tree``'s leaves laid over ``module`` (a
    residual or gradient tree of the reference); ``None`` leaves are left
    out."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree_paths(module, tree).items()
            if v.dtype != object}
