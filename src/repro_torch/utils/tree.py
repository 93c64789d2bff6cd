"""Small tree utilities, the port of the reference's ``utils/tree.py``.

A tree is a nested dict, tuple or list of tensors (meta tensors included);
``None`` is an empty subtree.  Sizes and bytes read only ``shape`` and
``dtype``, so a tree of meta tensors (``launch/dryrun.py``'s) costs
nothing to count.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (dict values in insertion order)."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of one or more trees of the same structure."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _numel(x) -> int:
    return math.prod(tuple(x.shape))


def param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(_numel(x) for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Total bytes of a tree of tensors (meta tensors included)."""
    return sum(_numel(x) * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    """Cast every floating leaf of a tree to ``dtype``; integer leaves are
    left alone."""
    return tree_map(lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves of a tree, the squares summed in f32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
