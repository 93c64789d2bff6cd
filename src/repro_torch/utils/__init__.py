from repro_torch.utils.cost import collective_bytes, collective_calls
from repro_torch.utils.tree import (
    global_norm,
    param_bytes,
    param_count,
    tree_add,
    tree_cast,
    tree_scale,
    tree_zeros_like,
)

__all__ = [
    "param_count",
    "param_bytes",
    "tree_cast",
    "tree_zeros_like",
    "tree_add",
    "tree_scale",
    "global_norm",
    "collective_bytes",
    "collective_calls",
]
