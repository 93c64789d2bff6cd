"""Device meshes on ``torch.distributed``, the port of the reference's
``launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` ``("data", "model")`` (``("pod", "data", "model")`` for
the multi-pod layout, ``("pipe",)`` for GPipe), over one process per rank.  The world comes from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or, without it, is a world of one process (an in-memory store, no network).

The backend is ``nccl`` when every rank on a host has a card of its own and
``gloo`` otherwise: ranks that share one card (NCCL refuses two ranks on one
device) or run on the CPU.  The process group is created first, with that
backend and a timeout, and the mesh is built on it, so a mesh on a shared
card runs its collectives over ``gloo`` (``dist/comm.py`` says which
collectives ``gloo`` carries on card tensors).

``make_production_mesh`` describes the reference's TPU pod layouts (16 x 16,
or 2 x 16 x 16 with a ``"pod"`` axis) as a :class:`MeshSpec`, shapes and
names only, for code that reads a layout without running it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

#: the process group's timeout: a rank that hangs fails its collectives
#: after this long instead of waiting forever
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's layout without processes: ``shape`` and ``mesh_dim_names``
    (the attribute names of a ``DeviceMesh``), the ``backend`` its
    collectives would take and the ``rank`` that plays it.  Bound with
    ``dist.comm.bound``, it takes the dry route: collectives count their
    bytes and compute nothing (``dist/comm.py``)."""

    shape: tuple
    mesh_dim_names: tuple
    backend: str = "nccl"
    rank: int = 0

    #: read by ``dist/comm.py``: a mesh without processes
    is_dry = True

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_local_rank(self, name: str) -> int:
        """``rank``'s coordinate along the axis ``name`` (row-major)."""
        coords, r = [], self.rank
        for ext in reversed(self.shape):
            coords.append(r % ext)
            r //= ext
        return coords[::-1][self.mesh_dim_names.index(name)]


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's 16x16 single-pod (256 chips) or 2x16x16 multi-pod
    (512 chips) layout, as a description."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Largest valid ``(data, model)`` factoring of ``n_devices``: the model
    axis takes the largest divisor that is <= sqrt(n) (so data >= model),
    data takes the rest.  256 -> (16, 16); 8 -> (4, 2); 6 -> (3, 2);
    4 -> (2, 2); 1 -> (1, 1)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    model = 1
    for m in range(1, math.isqrt(n_devices) + 1):
        if n_devices % m == 0:
            model = m
    return (n_devices // model, model)


def world_from_env() -> tuple[int, int, int]:
    """``(rank, world_size, local_rank)`` from the ``torchrun`` environment,
    or ``(0, 1, 0)`` without it."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, 0
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))


def backend_for(device_type: str, local_world: int | None = None) -> str:
    """``nccl`` when ``device_type`` is ``cuda`` and every one of the
    ``local_world`` ranks of this host (by default ``torchrun``'s
    ``LOCAL_WORLD_SIZE``, or the world size) has a card of its own, else
    ``gloo``."""
    if device_type != "cuda":
        return "gloo"
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_from_env()[1]))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def init_world(device_type: str = "cuda", *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Create the default process group unless one exists; returns its
    backend.  ``init_method`` (``file://...`` or ``tcp://localhost:<port>``)
    with ``rank`` and ``world_size`` names the world; without them it comes
    from the ``torchrun`` environment, or is a world of one process over an
    in-memory store."""
    if dist.is_initialized():
        return dist.get_backend()
    # a file store or a localhost address: every rank is on this host
    backend = backend_for(device_type, world_size if init_method is not None else None)
    timeout = timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "WORLD_SIZE" in os.environ:
        env_rank, env_world, local_rank = world_from_env()
        if backend == "nccl":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend, init_method="env://", rank=env_rank,
                                world_size=env_world, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    return backend


def make_auto_mesh(shape: tuple[int, ...] | None = None,
                   axes: tuple[str, ...] = ("data", "model"), device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group's world (created first by
    :func:`init_world` if needed).  With ``shape=None`` the largest valid
    ``(data, model)`` factoring of the world size (:func:`auto_mesh_shape`):
    a world of 1 gives a (1, 1) mesh.  An explicit ``shape`` must multiply
    out to the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    init_world(device_type)
    n = dist.get_world_size()
    if shape is None:
        shape = auto_mesh_shape(n)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes} does not match the world of "
                         f"{n} processes")
    if device_type == "cuda":
        # this rank's card (the one card ranks share), chosen before the mesh
        # would guess it
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    layout = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(axes))


def parse_mesh_arg(value: str, device_type: str = "cuda"):
    """Parse a launcher ``--mesh`` value: ``""`` -> no mesh, ``"auto"`` ->
    the auto factoring, ``"d,m"`` -> an explicit ``("data", "model")``
    shape, ``"p,d,m"`` -> the multi-pod ``("pod", "data", "model")`` shape;
    the product must equal the world size."""
    if not value:
        return None
    if value == "auto":
        return make_auto_mesh(device_type=device_type)
    try:
        shape = tuple(int(t) for t in value.split(","))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh must be 'auto', 'd,m' or 'p,d,m' (comma-separated ints whose "
                         f"product is the world size), got {value!r}")
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_auto_mesh(shape, axes, device_type=device_type)


def make_test_mesh(n_data: int | None = None, n_model: int | None = None,
                   device_type: str = "cpu"):
    """A small mesh for multi-process tests, through :func:`make_auto_mesh`;
    with no arguments it adapts to the world size."""
    if n_data is None and n_model is None:
        return make_auto_mesh(device_type=device_type)
    return make_auto_mesh((n_data or 2, n_model or 2), device_type=device_type)


def describe(mesh) -> str:
    """``"DxM"`` (``"PxDxM"``) of a mesh's shape, or ``"none"``."""
    return "none" if mesh is None else "x".join(str(s) for s in mesh.shape)


def launcher_mesh(value: str, device: str):
    """A launcher's ``--mesh`` mesh on ``device``'s type (None for ``""``),
    announced as ``mesh=DxM`` with the process group's backend and the
    rank, as the reference's launchers print it."""
    mesh = parse_mesh_arg(value, device_type=torch.device(device).type)
    if mesh is not None:
        print(f"mesh={describe(mesh)} backend={dist.get_backend()} rank={dist.get_rank()}/"
              f"{dist.get_world_size()}", flush=True)
    return mesh
