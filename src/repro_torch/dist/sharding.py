"""Which leaves split over a mesh's data axes: the data-axis part of the
reference's ``dist/sharding.py``.

One process per rank holds the whole replicated state (parameters,
optimizer moments); a batch splits on its leading axis over the combined
data axes (``("pod", "data")`` on a multi-pod mesh), each rank taking its
contiguous block of rows, and stays whole (replicated) when its extent does
not divide them.  A spec is what the reference's ``PartitionSpec`` entry for
the leading axis would be: the data entry (an axis name, or the tuple of
names on a multi-pod mesh) or ``None`` for a replicated leaf.

The model-axis rules (``params_pspecs``, ``opt_pspecs``, ``cache_pspecs``,
``layer_slice_pspecs``) wait for the model-sharded meshes (ROADMAP.md queue
1, item 7 part 2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch

MODEL_AXIS = "model"
#: mesh axes treated as (replicated-param) data-parallel axes, in mesh order
DATA_AXIS_NAMES = ("pod", "data")


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def data_axis_names(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axis names (``("data",)``, or ``("pod",
    "data")`` on a multi-pod mesh), in mesh order."""
    return tuple(a for a in _names(mesh) if a in DATA_AXIS_NAMES)


def axis_size(mesh, name: str) -> int:
    names = _names(mesh)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def data_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axis_names(mesh)) or 1


def data_entry(mesh):
    """The spec entry that splits one dim over all data axes (a single axis
    name, or the tuple of names on a multi-pod mesh)."""
    names = data_axis_names(mesh)
    return names if len(names) > 1 else names[0]


def data_index(mesh) -> int:
    """This rank's index along the combined data axes (row-major over them)."""
    idx = 0
    for a in data_axis_names(mesh):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _split(shape, n_data: int) -> bool:
    return bool(shape) and n_data > 1 and shape[0] >= n_data and shape[0] % n_data == 0


def batch_pspecs(batch, mesh):
    """Leading-axis (batch) split over the combined data axes, per leaf of a
    tensor, a dict or a tuple: the data entry, or ``None`` where the leaf
    stays whole (its batch extent does not divide the data axes)."""
    n_data = data_size(mesh)
    entry = data_entry(mesh) if data_axis_names(mesh) else None

    def spec(v):
        if isinstance(v, Mapping):
            return {k: spec(u) for k, u in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(spec(u) for u in v)
        return entry if _split(tuple(getattr(v, "shape", ()) or ()), n_data) else None

    return spec(batch)


@dataclass(frozen=True)
class BatchSharding:
    """The leading-axis split of a batch over a mesh's data axes: rank
    ``index`` of ``n`` takes rows ``[index * b / n, (index + 1) * b / n)``."""

    n: int
    index: int

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``v`` (``v`` itself when its extent does not
        divide)."""
        if not _split(tuple(v.shape), self.n):
            return v
        rows = v.shape[0] // self.n
        return v[self.index * rows:(self.index + 1) * rows]


def batch_sharding(mesh) -> BatchSharding:
    """This rank's leading-axis batch split on ``mesh``."""
    return BatchSharding(data_size(mesh), data_index(mesh))
