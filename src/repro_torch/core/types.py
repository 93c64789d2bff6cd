"""The ``Invertible`` protocol, parameter trees and device resolution.

A layer is invertible by design: ``forward(x, cond=None)`` returns the output
together with the per-sample log-determinant of its Jacobian (shape ``(B,)``,
float32), and ``inverse(y, cond=None)`` undoes it.  ``x``/``y`` are a tensor
or, for multiscale networks, a tuple of tensors in the reference's leaf order.
Layers that do not use ``cond`` accept and ignore it.

Parameters live on the modules (``nn.Parameter``); integer leaves of the
reference (permutations, signs) are registered buffers, which optimizers never
see.  ``ParamTree`` turns a nested dict of tensors (the reference's parameter
pytree) into modules, so ``state_dict()`` keys read like its tree paths.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a card and without an explicit device this raises;
    the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def to_device(v, device):
    """``v`` on ``device``: a tensor or a numpy array (float64 arrays become
    float32, as the reference's ``jnp.asarray`` makes them), or a dict of
    them; None stays None."""
    if v is None:
        return None
    if isinstance(v, Mapping):
        return {k: to_device(u, device) for k, u in v.items()}
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
    return v.to(device)


class Invertible(nn.Module):
    """Base class for invertible layers and networks."""

    def forward(self, x, cond=None):
        raise NotImplementedError

    def inverse(self, y, cond=None):
        raise NotImplementedError


def zero_logdet(x) -> torch.Tensor:
    lead = x[0] if isinstance(x, tuple) else x
    return torch.zeros(lead.shape[0], dtype=torch.float32, device=lead.device)


class ParamTree(nn.Module):
    """A nested dict of tensors as modules: dicts become child ``ParamTree``s,
    floating tensors parameters, integer tensors buffers.  Children are read
    by attribute or by ``tree["key"]``."""

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            elif value.is_floating_point():
                self.register_parameter(key, nn.Parameter(value))
            else:
                self.register_buffer(key, value)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._buffers or key in self._modules


def share_parameters(dst: nn.Module, src: nn.Module) -> nn.Module:
    """Make ``dst`` hold ``src``'s own parameter and buffer tensors: two
    builds of one network (a serving twin with other kernel options, say)
    with one parameter set, so training or moving ``src`` is seen by
    ``dst``.  Raises unless the two have the same parameters and buffers
    by name and shape.  Returns ``dst``."""
    s_state, d_state = src.state_dict(keep_vars=True), dst.state_dict(keep_vars=True)
    if s_state.keys() != d_state.keys() or any(
            s_state[k].shape != d_state[k].shape for k in s_state):
        raise ValueError("share_parameters: the two modules differ in their parameters")
    for name, mod in dst.named_modules():
        prefix = f"{name}." if name else ""
        for key in list(mod._parameters):
            if mod._parameters[key] is not None:
                mod._parameters[key] = s_state[prefix + key]
        for key in list(mod._buffers):
            if mod._buffers[key] is not None and prefix + key in s_state:
                mod._buffers[key] = s_state[prefix + key]
    return dst


class StackSlices:
    """Per-step access to a module whose leaves are stacked along their
    first axis (a scan's steps): the number of steps, step ``i``'s slice of
    every leaf as a nested dict (:func:`tree_index`), and where step ``i``'s
    gradient goes in a gradient shaped like the parameters as stored
    (``core/autodiff.py::scan_backward``).  This class reads the parameters
    as they are stored; a layout that stores a stack otherwise sets its own
    subclass as the module's ``step_slices`` attribute (``dist/model.py``
    does, on a model-sharded mesh)."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __len__(self) -> int:
        return next(self.module.parameters()).shape[0]

    def leaf(self, name: str, p: torch.Tensor, i: int, detach: bool) -> torch.Tensor:
        """Step ``i``'s slice of the parameter ``name`` (dotted, from the
        stack's root)."""
        return p[i].detach().requires_grad_() if detach else p[i]

    def put_row(self, name: str, g_stacked: torch.Tensor, i: int, g: torch.Tensor):
        """Write step ``i``'s gradient ``g`` of ``name`` into ``g_stacked``."""
        g_stacked[i] = g

    def index(self, i: int, detach: bool = False) -> dict:
        def walk(tree, prefix):
            out = {n: walk(child, f"{prefix}{n}.") for n, child in tree.named_children()}
            for n, p in tree.named_parameters(recurse=False):
                out[n] = self.leaf(prefix + n, p, i, detach)
            for n, b in tree.named_buffers(recurse=False):
                out[n] = b[i]
            return out

        return walk(self.module, "")


def stack_slices(module: nn.Module) -> StackSlices:
    """``module``'s ``step_slices`` accessor, or one that reads its
    parameters as stored."""
    slices = getattr(module, "step_slices", None)
    return StackSlices(module) if slices is None else slices


def tree_index(tree, i: int, detach: bool = False) -> dict:
    """Slice ``i`` of every leaf of a stacked module tree (the counterpart
    of the reference's per-step scan slice), as a nested dict, through the
    module's :func:`stack_slices`.  With ``detach`` each parameter slice is a
    detached leaf that requires grad, so a step's VJP reaches it without a
    gradient the size of the whole stack."""
    return stack_slices(tree).index(i, detach)


def tree_dict(tree) -> dict:
    """A module tree's parameters and buffers as a nested dict of the same
    tensors (``tree_index`` without the slice)."""
    out = {name: tree_dict(child) for name, child in tree.named_children()}
    out.update(tree.named_parameters(recurse=False))
    out.update(tree.named_buffers(recurse=False))
    return out


def tree_leaves(tree: Mapping, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` of every floating leaf of a nested dict, in
    order; the names are those of ``named_parameters()`` on the module the
    dict was sliced from."""
    out = []
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out += tree_leaves(value, f"{prefix}{key}.")
        elif value.is_floating_point():
            out.append((prefix + key, value))
    return out


def stack_trees(trees: list[dict]) -> dict:
    """Stack a list of identically-structured nested dicts leaf-wise."""
    first = trees[0]
    return {
        k: stack_trees([t[k] for t in trees])
        if isinstance(first[k], Mapping)
        else torch.stack([t[k] for t in trees])
        for k in first
    }
