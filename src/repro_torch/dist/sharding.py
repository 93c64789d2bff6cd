"""Where every state leaf lives on a ``("data", "model")`` mesh (or a
``("pod", "data", "model")`` multi-pod mesh): the port of the reference's
``dist/sharding.py``.

One rule set covers every state tree the port moves across ranks, with the
reference's arithmetic:

* **params** (:func:`params_pspecs`) - each leaf splits over ``"model"``
  along its largest divisible axis (later axes win ties: output features
  before input features).  1-D leaves and leaves with no divisible axis
  replicate; a layer-stacked leaf (ndim >= 3) never splits its leading stack
  axis.  ``fsdp=True`` splits a second axis over the data axes;
* **per-layer slices** (:func:`layer_slice_pspecs`) - the same model split
  of one layer's slice of a stacked tree (its stack axis dropped);
* **batch** (:func:`batch_pspecs`) - the leading axis over the combined data
  axes, whole when its extent does not divide them (the leading entry
  alone);
* **optimizer** (:func:`opt_pspecs`) - each moment mirrors its parameter's
  spec (``None`` moments stay ``None``); ``zero1=True`` splits each moment
  over the data axes along its largest still-whole divisible axis; the step
  counter replicates;
* **caches** (:func:`cache_pspecs`) - a layer-stacked cache leaf ``(L, B,
  ...)`` splits its batch axis over the data axes; ``seq_fallback_model=True``
  splits the sequence axis (axis 2) of KV-like leaves (ndim >= 4) over
  ``"model"``.

A spec is a tuple that mirrors the reference's ``PartitionSpec``: one entry a
dimension, an axis name, a tuple of names (the data axes of a multi-pod
mesh) or ``None``, with trailing ``None`` entries dropped (``()`` is a whole
leaf).  The rules read only ``.shape`` of a leaf and ``shape`` /
``mesh_dim_names`` of a mesh (a ``DeviceMesh``, a ``launch.mesh.MeshSpec``),
and walk dicts, tuples and lists.

:func:`local_shard` cuts this rank's block of a leaf by its spec and
:func:`gather_shard` puts the leaf back whole from every rank's block through
``dist/comm.py`` (the bytes are counted), the data axes first, so that a
stacked leaf's slice passes through the spec :func:`layer_slice_pspecs`
gives; :func:`reduce_shard` takes a gradient of the whole leaf back to this
rank's block, summed over the data axes (a reduce-scatter) where the spec
splits over them.  ``fsdp`` and ``zero1`` are read by ``dist/model.py`` and
``dist/step.py``, ``seq_fallback_model`` by ``serve/engine.py``.
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


def model_size(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, MODEL_AXIS)


def data_entry(mesh):
    """The spec entry that splits one dim over all data axes (a single axis
    name, or the tuple of names on a multi-pod mesh)."""
    names = data_axis_names(mesh)
    return names if len(names) > 1 else names[0]


def entry_names(entry) -> tuple:
    """The mesh axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_index(mesh, entry) -> int:
    """This rank's index along the axes of ``entry``, row-major over them."""
    idx = 0
    for a in entry_names(entry):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def entry_size(mesh, entry) -> int:
    return math.prod(axis_size(mesh, a) for a in entry_names(entry))


def data_index(mesh) -> int:
    """This rank's index along the combined data axes (row-major over them)."""
    return entry_index(mesh, data_axis_names(mesh))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()) or ())


def _best_axis(shape, size: int, taken=()) -> int | None:
    """Largest-extent axis divisible by ``size`` (later axes win ties)."""
    best = None
    for d, ext in enumerate(shape):
        if d in taken or size <= 1 or ext < size or ext % size:
            continue
        if best is None or ext >= shape[best]:
            best = d
    return best


def _spec(entries) -> tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict / tuple / list (``None`` is
    kept as ``None``, as an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_pspecs(params, mesh, fsdp: bool = False):
    """The spec tree of a parameter tree (see the module docstring); the
    result has the input's structure."""
    n_model = axis_size(mesh, MODEL_AXIS)
    n_data = data_size(mesh)

    def leaf_spec(leaf):
        shape = _shape(leaf)
        if len(shape) < 2:
            return ()
        # never split the leading stack axis of a layer-stacked leaf
        taken = {0} if len(shape) >= 3 else set()
        entries: list = [None] * len(shape)
        m_ax = _best_axis(shape, n_model, taken)
        if m_ax is not None:
            entries[m_ax] = MODEL_AXIS
            taken.add(m_ax)
        if fsdp and n_data > 1:
            d_ax = _best_axis(shape, n_data, taken)
            if d_ax is not None:
                entries[d_ax] = data_entry(mesh)
        return _spec(entries)

    return tree_map(leaf_spec, params)


def layer_slice_pspecs(stacked, mesh):
    """Specs of one layer's slice of a layer-stacked tree (the stack axis
    dropped), split over ``"model"`` only."""
    n_model = axis_size(mesh, MODEL_AXIS)

    def leaf_spec(leaf):
        shape = _shape(leaf)[1:]
        if len(shape) < 2:
            return ()
        entries: list = [None] * len(shape)
        m_ax = _best_axis(shape, n_model)
        if m_ax is not None:
            entries[m_ax] = MODEL_AXIS
        return _spec(entries)

    return tree_map(leaf_spec, stacked)


def batch_pspecs(batch, mesh):
    """Leading-axis (batch) split over the combined data axes, per leaf: the
    entry of the leading axis (the data entry), or ``None`` where the leaf
    stays whole (its batch extent does not divide the data axes).  The
    reference returns ``PartitionSpec(entry)``; the leading entry is all
    that a batch spec holds."""
    n_data = data_size(mesh)
    entry = data_entry(mesh) if data_axis_names(mesh) else None

    def leaf_spec(leaf):
        return entry if _split(_shape(leaf), n_data) else None

    return tree_map(leaf_spec, batch)


def _has_leaves(tree) -> bool:
    if tree is None:
        return False
    if isinstance(tree, Mapping):
        return any(_has_leaves(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has_leaves(v) for v in tree)
    return True


def opt_pspecs(opt_spec, p_specs, mesh, zero1: bool = False):
    """Optimizer-state specs mirroring the parameter specs ``p_specs``.
    ``opt_spec`` is the AdamW state (``{"mu", "nu", "step"}``; a moment is
    ``None`` for an integer leaf).  With ``zero1`` each moment also splits
    over the data axes along its largest still-whole divisible axis."""
    n_data = data_size(mesh)

    def moment_spec(m, psp):
        if m is None:
            return None
        shape = _shape(m)
        entries = list(psp) + [None] * (len(shape) - len(psp))
        if zero1 and n_data > 1:
            taken = {d for d, e in enumerate(entries) if e is not None}
            d_ax = _best_axis(shape, n_data, taken)
            if d_ax is not None:
                entries[d_ax] = data_entry(mesh)
        return _spec(entries)

    def mirror(m, psp):
        # driven by the moments' structure: the specs' leaves are tuples too
        if m is None:
            return None
        if isinstance(m, Mapping):
            return {k: mirror(v, psp[k]) for k, v in m.items()}
        if isinstance(m, (tuple, list)):
            return type(m)(mirror(v, p) for v, p in zip(m, psp))
        return moment_spec(m, psp)

    out = {}
    for key, sub in opt_spec.items():
        if not _shape(sub) and not _has_leaves(sub):
            out[key] = sub  # an empty subtree (all-None moments)
        elif key in ("mu", "nu"):
            out[key] = mirror(sub, p_specs)
        else:  # the step counter and anything unrecognised: replicate
            out[key] = tree_map(lambda _: (), sub)
    return out


def cache_pspecs(caches, mesh, seq_fallback_model: bool = False):
    """Serve-cache specs: a layer-stacked cache leaf ``(L, B, ...)`` splits
    its batch axis (axis 1) over the data axes; ``seq_fallback_model`` also
    splits the sequence axis (axis 2) of KV-like leaves (ndim >= 4) over
    ``"model"``."""
    n_model = axis_size(mesh, MODEL_AXIS)
    n_data = data_size(mesh)

    def leaf_spec(leaf):
        shape = _shape(leaf)
        if len(shape) < 2:
            return ()
        entries: list = [None] * len(shape)
        if n_data > 1 and shape[1] >= n_data and shape[1] % n_data == 0:
            entries[1] = data_entry(mesh)
        if (seq_fallback_model and n_model > 1 and len(shape) >= 4
                and shape[2] % n_model == 0 and shape[2] >= n_model):
            entries[2] = MODEL_AXIS
        return _spec(entries)

    return tree_map(leaf_spec, caches)


def state_pspecs(state, mesh):
    """Specs of a ``{"params", "opt", "err"}`` train state, the reference's
    ``train/loop.py::_state_shardings``: the parameters by
    :func:`params_pspecs`, the AdamW moments mirroring them
    (:func:`opt_pspecs`), the error-feedback residuals split over the data
    axes along their leading per-rank axis (whole without data axes)."""
    p_specs = params_pspecs(state["params"], mesh)
    entry = (data_entry(mesh),) if data_axis_names(mesh) else ()
    return {"params": p_specs, "opt": opt_pspecs(state["opt"], p_specs, mesh),
            "err": tree_map(lambda _: entry, state.get("err") or {})}


# ---------------------------------------------------------------------------
# a leaf's block on this rank, and the leaf whole again
# ---------------------------------------------------------------------------


def local_shard(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: along each split
    dimension, block ``entry_index`` of ``entry_size`` equal blocks (a view;
    ``.clone()`` it to free the whole leaf)."""
    out = leaf
    for d, entry in enumerate(spec or ()):
        n = entry_size(mesh, entry)
        if n <= 1:
            continue
        ext = out.shape[d] // n
        out = out.narrow(d, entry_index(mesh, entry) * ext, ext)
    return out


def is_data_entry(entry) -> bool:
    """True when a spec entry splits over data axes (``fsdp``'s, ``zero1``'s)."""
    names = entry_names(entry)
    return bool(names) and all(a in DATA_AXIS_NAMES for a in names)


def model_part(spec) -> tuple:
    """``spec`` with its data-axis entries dropped."""
    return _spec(None if is_data_entry(e) else e for e in spec or ())


def gather_shard(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (:func:`local_shard`'s
    inverse): one ``all_gather`` over each split dimension's axes, counted by
    ``dist/comm.py``, the data axes first.  A collective: every rank of
    those axes calls it."""
    from repro_torch.dist import comm

    out = local
    order = sorted(enumerate(spec or ()), key=lambda de: not is_data_entry(de[1]))
    for d, entry in order:
        if entry_size(mesh, entry) <= 1:
            continue
        stacked = comm.all_gather(out.contiguous(), comm.mesh_group(mesh, entry_names(entry)))
        out = torch.cat(stacked.unbind(0), dim=d)
    return out


def reduce_shard(g: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a gradient ``g`` of the whole leaf, summed over
    the data axes where ``spec`` splits over them: the model-axis dimensions
    cut (every rank of a ``model`` row holds the same ``g``), then one
    ``reduce_scatter`` over each data entry's axes (each data rank's ``g``
    is its rows' part).  A collective on the data axes."""
    from repro_torch.dist import comm

    out = local_shard(g, model_part(spec), mesh)
    for d, entry in enumerate(spec or ()):
        if is_data_entry(entry) and entry_size(mesh, entry) > 1:
            out = comm.reduce_scatter(out.contiguous(), comm.mesh_group(mesh, entry_names(entry)),
                                      dim=d)
    return out.contiguous()


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------


def _split(shape, n_data: int) -> bool:
    return bool(shape) and n_data > 1 and shape[0] >= n_data and shape[0] % n_data == 0


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
