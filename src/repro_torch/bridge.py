"""Carry a parameter tree of the reference across into the port's modules.

``params_from_numpy(module, tree)`` loads the tree that the reference's
``init`` returns, with every leaf already a numpy array (the caller maps
``np.asarray`` over it), into ``module``:

* tuple index ``i`` maps to ``layers.{i}`` and dict keys to attribute names,
  so ``state_dict()`` keys read like the tree's paths
  (``layers.2.layer.lu.l``; ``OnFirst`` adds ``layer.``, since the reference's
  ``OnFirst`` passes its layer's parameters through);
* integer leaves land in integer buffers and keep their dtype;
* it raises on a leaf left unmapped on either side, on a shape mismatch and on
  a float/integer mismatch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.chain import OnFirst


def tree_paths(module, tree) -> dict[str, np.ndarray]:
    """``{state_dict key: leaf}`` for every leaf of ``tree`` laid over ``module``."""
    out: dict[str, np.ndarray] = {}

    def walk(mod, sub, prefix):
        while isinstance(mod, OnFirst):
            mod, prefix = mod.layer, prefix + "layer."
        if isinstance(sub, (tuple, list)):
            for i, leaf in enumerate(sub):
                walk(mod.layers[i], leaf, f"{prefix}layers.{i}.")
        elif isinstance(sub, Mapping):
            for key, leaf in sub.items():
                child = getattr(mod, key, None) if isinstance(leaf, Mapping) else mod
                if child is None:
                    raise KeyError(f"no submodule {prefix}{key} for the tree's {key!r}")
                walk(child, leaf, f"{prefix}{key}." if isinstance(leaf, Mapping) else prefix + key)
        else:
            out[prefix] = np.asarray(sub)

    walk(module, tree, "")
    return out


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
