"""Every collective the port issues, with the bytes it hands to the wire.

The counterpart of the reference's ``utils/hlo.py::collective_bytes``, the
walk over a compiled program's collectives that the reference's
``test_compressed_step_reduces_wire_bytes`` reads: here each call counts,
as it is made, the bytes of the tensors it hands to ``torch.distributed``,
by collective and by dtype (:func:`wire_bytes`), and the calls.  An
``all_reduce`` counts its tensor, an ``all_gather`` this rank's input, a
``reduce_scatter`` its whole input (the reference's walker counts a
reduce-scatter's result times its group), a ``send`` its tensor and a
``recv`` nothing (the sender counted it).

``gloo`` has no reduce-scatter: on a ``gloo`` group :func:`reduce_scatter`
all-reduces its input and keeps this rank's block, and counts what it
issued, an ``all_reduce`` of the whole input.

``gloo`` carries card tensors for ``all_reduce`` and ``all_gather`` (checked
on an H100 with PyTorch 2.11; gloo stages them through the host itself).  Its ``send`` and ``recv`` take host memory only (a
card tensor aborts the process), so for those a card tensor on a ``gloo``
group is copied to the host and back here, explicitly, and those bytes are
counted apart as ``host_staged`` (each direction once).  Nothing is computed
on the host here: the copies carry the values, and every sum of gathered
values runs on the tensors' own device.

Mesh axes are named as in the reference (``psum_axis="data"``, or
``("pod", "data")`` for the two data axes of a multi-pod mesh): :func:`bound`
makes a mesh current for the engines' backward passes and the model-sharded
layers, and :func:`axis_group` resolves a name, or a tuple of names, against
it.  A tuple's group is the ranks that differ only along those axes, ranked
row-major over them (:func:`mesh_group`).

**The dry route.**  Bound to a ``launch.mesh.MeshSpec`` (a layout without
processes), ``bound`` plays that mesh's rank ``spec.rank`` with no process
group: a group is a :class:`DryGroup` (its size and the backend the mesh
would use), every collective returns a tensor of the right shape on its
input's device (meta tensors in ``launch/dryrun.py``) without computing
anything, and adds its bytes to the same :func:`wire_bytes` table, under
the collective that backend would issue.  So a 256- or 512-rank mesh's wire
is reckoned in one process, by the code that runs on the card.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter

import torch
import torch.distributed as dist

#: collectives that ``gloo`` runs on card tensors itself
GLOO_DEVICE_COLLECTIVES = ("all_reduce", "all_gather")

_WIRE: Counter = Counter()
_CALLS: Counter = Counter()
_STAGED: Counter = Counter()
_BOUND: list = []


class DryGroup:
    """A group of the dry route: ``size`` ranks over ``backend``, no
    processes; ``index`` is the playing rank's place in it."""

    def __init__(self, size: int, backend: str, index: int = 0):
        self.size, self.backend, self.index = int(size), backend, int(index)


class _Done:
    """The work handle of a dry asynchronous collective."""

    def wait(self):
        return None


def _dry(group) -> bool:
    return isinstance(group, DryGroup)


def _size(group) -> int:
    return group.size if _dry(group) else dist.get_world_size(group)


def _backend(group) -> str:
    return group.backend if _dry(group) else dist.get_backend(group)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


#: functions called with ``(op, tensor)`` at each count (``utils/cost.py``'s
#: counter)
_LISTENERS: list = []


def add_listener(fn):
    _LISTENERS.append(fn)


def remove_listener(fn):
    _LISTENERS.remove(fn)


def _count(op: str, t: torch.Tensor):
    _WIRE[(op, _dtype_name(t))] += t.numel() * t.element_size()
    _CALLS[op] += 1
    for fn in _LISTENERS:
        fn(op, t)


def wire_bytes() -> dict:
    """``{"by_op": {op: bytes}, "by_op_dtype": {"op/dtype": bytes}, "total",
    "calls": {op: n}, "host_staged": {"op/dtype": bytes},
    "host_staged_total"}`` since the last :func:`reset_wire_bytes`."""
    by_op: Counter = Counter()
    for (op, _), n in _WIRE.items():
        by_op[op] += n
    return {"by_op": dict(by_op), "by_op_dtype": {f"{o}/{d}": n for (o, d), n in _WIRE.items()},
            "total": sum(_WIRE.values()), "calls": dict(_CALLS),
            "host_staged": {f"{o}/{d}": n for (o, d), n in _STAGED.items()},
            "host_staged_total": sum(_STAGED.values())}


def reset_wire_bytes():
    _WIRE.clear()
    _CALLS.clear()
    _STAGED.clear()


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """True when ``op`` on ``t`` must be copied through the host: a card
    tensor on a ``gloo`` group and a collective ``gloo`` takes on the host
    only."""
    return (t.device.type == "cuda" and op not in GLOO_DEVICE_COLLECTIVES
            and _backend(group) == "gloo")


def _to_host(op: str, t: torch.Tensor) -> torch.Tensor:
    _STAGED[(op, _dtype_name(t))] += t.numel() * t.element_size()
    return t.to("cpu")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group=None, async_op: bool = False, op: str = "sum"):
    """Reduce ``t`` in place over ``group`` (``op`` ``"sum"`` or ``"max"``);
    returns the work handle when ``async_op``."""
    _count("all_reduce", t)
    if _dry(group):
        return _Done() if async_op else None
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return dist.all_reduce(t, op=red, group=group, async_op=async_op)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(group size, *t.shape)``: every rank's ``t``, in rank order, on
    ``t``'s device."""
    _count("all_gather", t)
    if _dry(group):
        return t.new_empty((group.size, *t.shape))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``
    (``t.shape[dim]`` divides by the group's size).  ``nccl`` issues a
    reduce-scatter; ``gloo``, which has none, an ``all_reduce`` of a copy of
    ``t``, counted as such."""
    n = _size(group)
    rows = t.shape[dim] // n
    if n * rows != t.shape[dim]:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not divide by {n}")
    if _backend(group) == "gloo":
        whole = t.clone()
        all_reduce(whole, group)
        idx = group.index if _dry(group) else dist.get_rank(group)
        return whole.narrow(dim, idx * rows, rows).contiguous()
    _count("reduce_scatter", t)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((rows, *src.shape[1:]))
    if not _dry(group):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def send(t: torch.Tensor, dst: int, group=None):
    """``t`` to global rank ``dst`` (blocks until it is handed over)."""
    _count("send", t)
    if _dry(group):
        return
    if _staged("send", t, group):
        t = _to_host("send", t.contiguous())
    dist.send(t.contiguous(), dst=dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` from global rank ``src``; returns ``t``."""
    if _dry(group):
        return t
    if _staged("recv", t, group):
        host = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(host, src=src, group=group)
        _STAGED[("recv", _dtype_name(t))] += host.numel() * host.element_size()
        t.copy_(host)
        return t
    dist.recv(t, src=src, group=group)
    return t


def barrier():
    """Wait for every rank of the world, when there is more than one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# mesh axes by name
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def bound(mesh):
    """Make ``mesh`` current: inside, :func:`axis_group` resolves its axis
    names (the engines' ``psum_axis``).  Not thread-local: the backward of a
    card tensor runs on autograd's device thread.  A ``MeshSpec`` takes the
    dry route (module docstring)."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def current_mesh():
    """The mesh :func:`bound` made current, or None."""
    return _BOUND[-1] if _BOUND else None


def axis_group(axis):
    """``(group, size)`` of the current mesh's axis ``axis`` (a name, or a
    tuple of names: their combined group); raises when no mesh is bound or
    the mesh has no such axis."""
    if not _BOUND:
        raise RuntimeError(f"axis {axis!r} is not bound: reduce over a mesh axis only inside "
                           "repro_torch.dist.comm.bound(mesh) (the data-parallel step binds it)")
    mesh = _BOUND[-1]
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh {mesh.mesh_dim_names} has no axis {a!r}")
    size = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)
    return mesh_group(mesh, names), size


#: the combined groups made so far, by the mesh's id and the axes' names
_GROUPS: dict = {}


def mesh_group(mesh, names):
    """The process group of the ranks that differ from this one only along
    the mesh axes ``names`` (a name or a tuple), ranked row-major over them.
    One axis is the mesh's own group; a tuple's groups are made on first use
    with ``new_group``, which every rank of the world calls in the same
    order (every rank takes the same code path to it)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    if getattr(mesh, "is_dry", False):
        size, index = 1, 0
        for a in names:
            ext = mesh.size(mesh.mesh_dim_names.index(a))
            size, index = size * ext, index * ext + mesh.get_local_rank(a)
        return DryGroup(size, mesh.backend, index)
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (id(mesh), names)
    if key not in _GROUPS:
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        layout = mesh.mesh.cpu()
        rest = [d for d in range(layout.ndim) if d not in dims]
        blocks = layout.permute(*rest, *dims).reshape(-1, math.prod(layout.shape[d]
                                                                    for d in dims))
        mine = None
        for ranks in blocks.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        # the mesh is kept alive with its groups, so its id is not reused
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


class GradReducer:
    """Sums gradient tensors over a mesh axis as they arrive: each
    :meth:`add` starts an asynchronous ``all_reduce`` in place, so the
    collectives run while the backward goes on; :meth:`wait` waits for them
    all.  Non-floating tensors and ``None`` are skipped."""

    def __init__(self, axis: str):
        self.group, self.size = axis_group(axis)
        self._works: list = []

    def add(self, tensors):
        for t in tensors:
            if self.size > 1 and t is not None and t.is_floating_point():
                self._works.append(all_reduce(t, self.group, async_op=True))

    def wait(self):
        for work in self._works:
            work.wait()
        self._works.clear()
