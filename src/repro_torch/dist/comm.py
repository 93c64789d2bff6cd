"""Every collective the port issues, with the bytes it hands to the wire.

The counterpart of the reference's ``utils/hlo.py::collective_bytes``, the
walk over a compiled program's collectives that the reference's
``test_compressed_step_reduces_wire_bytes`` reads: here each call counts,
as it is made, the bytes of the tensors it hands to ``torch.distributed``,
by collective and by dtype (:func:`wire_bytes`).  An ``all_reduce`` counts
its tensor, an ``all_gather`` this rank's input, a ``send`` its tensor and a
``recv`` nothing (the sender counted it).

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
_STAGED: Counter = Counter()
_BOUND: list = []


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _count(op: str, t: torch.Tensor):
    _WIRE[(op, _dtype_name(t))] += t.numel() * t.element_size()


def wire_bytes() -> dict:
    """``{"by_op": {op: bytes}, "by_op_dtype": {"op/dtype": bytes}, "total",
    "host_staged": {"op/dtype": bytes}, "host_staged_total"}`` since the last
    :func:`reset_wire_bytes`."""
    by_op: Counter = Counter()
    for (op, _), n in _WIRE.items():
        by_op[op] += n
    return {"by_op": dict(by_op), "by_op_dtype": {f"{o}/{d}": n for (o, d), n in _WIRE.items()},
            "total": sum(_WIRE.values()),
            "host_staged": {f"{o}/{d}": n for (o, d), n in _STAGED.items()},
            "host_staged_total": sum(_STAGED.values())}


def reset_wire_bytes():
    _WIRE.clear()
    _STAGED.clear()


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """True when ``op`` on ``t`` must be copied through the host: a card
    tensor on a ``gloo`` group and a collective ``gloo`` takes on the host
    only."""
    return (t.device.type == "cuda" and op not in GLOO_DEVICE_COLLECTIVES
            and dist.get_backend(group) == "gloo")


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
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return dist.all_reduce(t, op=red, group=group, async_op=async_op)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(group size, *t.shape)``: every rank's ``t``, in rank order, on
    ``t``'s device."""
    _count("all_gather", t)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def send(t: torch.Tensor, dst: int, group=None):
    """``t`` to global rank ``dst`` (blocks until it is handed over)."""
    _count("send", t)
    if _staged("send", t, group):
        t = _to_host("send", t.contiguous())
    dist.send(t.contiguous(), dst=dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` from global rank ``src``; returns ``t``."""
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
    card tensor runs on autograd's device thread."""
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
