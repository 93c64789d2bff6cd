"""Bindings of the hand-written CUDA flow-step kernels (``csrc/flowstep.cu``).

``flowstep_fwd``, ``flowstep_inv`` and ``spine_bwd`` replace the Pallas
kernels of the same names in ``repro/kernels/flowstep/flowstep.py``.  All
three are memory-bound at the served widths (12*B*M*C bytes a launch in f32
for the first two, 16*B*M*C for ``spine_bwd``); the source notes in
``flowstep.cu`` give the design.  Each has two kernels, chosen by a shape
rule: ``flowstep_fwd`` and ``flowstep_inv`` a persistent vectorised stream
at the GLOW widths when raw and t are the halves of one conditioner output
(:func:`flowstep_path`; its tiles as :func:`flow_walk` lists them), and the
per-tile kernel otherwise; ``spine_bwd`` one pass summed in thread-block
clusters at the GLOW widths, planned by :func:`spine_plan`, and the per-tile
kernel with its reduce at any other (:func:`spine_path`).  Each wrapper
checks what the kernel takes, allocates the outputs and scratch, launches on
PyTorch's current stream, raises if the launch was refused, and adds one to
its ``launches`` count and to the path's in ``launches_by_path``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES as _DTYPES
from repro_torch.kernels.common import (STREAM_PLAN, STREAM_WIDTHS, PathKernel, bind, raise_on,
                                        stream, stream_rows, stream_tiles)

#: shared memory a block may take without opting in to more
SMEM_LIMIT = 48 * 1024
#: elements a block stages: block_m = max(1, TILE_ELEMS // C) rows
TILE_ELEMS = 2048
#: ``spine_bwd``'s cluster kernel: the output columns a lane computes
#: (``kSpineOut``), the blocks of a cluster, the fewest rows worth another
#: cluster, and at each width (a template instance each,
#: ``launch_spine_cluster_c`` in ``flowstep.cu``) the clusters at most: the
#: fastest of ``tools/kernel_split.py --spine-plans`` on the H100
#: (``PERF.md``), two blocks an SM at C = 12 and 24, one at C = 48; clusters
#: of 4 to 16 blocks measured slower at every width
SPINE_OUT = 12
SPINE_CLUSTER, SPINE_MIN_ROWS = 2, 32
SPINE_PLAN = {12: 128, 24: 128, 48: 64}
SPINE_WIDTHS = tuple(SPINE_PLAN)
#: threads of a block, and what ``launches_by_path`` counts
THREADS, SPINE_PATHS, FLOW_PATHS = 256, ("cluster", "tile"), ("stream", "tile")
#: CUDA kernels one call launches, on either path: the step's kernel, and for
#: the forward the fixed-order sum of its tiles' ld partials (``ld_reduce_kernel``)
KERNELS_PER_CALL = {"flowstep_fwd": 2, "flowstep_inv": 1}
#: the flow-step streams' lane layout at each width, as ``STREAM_PLAN``'s:
#: (output columns, rows) a lane computes, warps a block (``FLOW_PLAN_<C>`` in
#: ``flowstep.cu``).  ``conv1x1_mm``'s at C = 12 and 48; at C = 24 a lane
#: takes a whole row, which ``tools/flow_plan_sweep.py`` timed fastest of
#: five plans a width on the H100 (``PERF.md``)
FLOW_PLAN = {**STREAM_PLAN, 24: (24, 1, 8)}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flowstep_fwd": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _P,
                     _I, _I, _I, _I, _I, _F, _I, _P],
    "flowstep_inv": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P,
                     _I, _I, _I, _I, _I, _F, _I, _P],
    "flowstep_stream": [_I, _I, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "spine_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _P],
    "spine_bwd_cluster": [_I, _P, _P, _P, _P, ctypes.POINTER(_L), _P, _P, _P, _P, _P, _P,
                          _L, _I, _L, _I, _I, _I, _I, _P],
    "spine_max_clusters": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
}


def _fn(name: str):
    return bind("flowstep", name, _SIGNATURES[name])


def smem_bytes(c: int, block_m: int) -> int:
    """Shared memory one block takes: W (C*C), exp(an_log_s) and an_b (2*C),
    the tile (block_m*C) and 8 warp sums, in f32 (``smem_bytes`` in
    ``flowstep.cu``)."""
    return 4 * (c * c + 2 * c + block_m * c + 8)


def flowstep_path(x, raw, t) -> str:
    """The kernel that computes ``flowstep_fwd(x, ..., raw, t)`` (x: y for
    ``flowstep_inv``): "stream" for C in ``STREAM_WIDTHS`` when raw and t
    are the two halves of one contiguous (B, M, C) tensor (``t`` starts C/2
    elements after ``raw``, rows C apart), as ``GlowStepStack`` passes its
    conditioner output, and x, raw and each batch's rows (M*C elements) are
    16-byte aligned (its 16-byte copies); "tile" otherwise."""
    b, m, c = x.shape
    ca, es = raw.shape[-1], x.element_size()
    halves = (2 * ca == c and raw.stride() == (m * c, c, 1)
              and t.data_ptr() == raw.data_ptr() + ca * es)
    aligned = (x.data_ptr() % 16 == 0 and raw.data_ptr() % 16 == 0
               and (b == 1 or m * c * es % 16 == 0))
    return "stream" if c in STREAM_WIDTHS and halves and aligned else "tile"


def flow_stream_smem_bytes(c: int, elem_size: int) -> int:
    """Shared memory of one stream block (``flow_stream_smem_bytes`` in
    ``flowstep.cu``): W, e^+-an_log_s and an_b in f32, and each warp's
    2-stage ring of (x | h) tiles in the storage type."""
    return 4 * (c * c + 2 * c) + FLOW_PLAN[c][2] * 2 * 2 * stream_rows(c, FLOW_PLAN) * c * elem_size


def flow_tiles_per_batch(m: int, c: int) -> int:
    """The stream's tiles of one batch: ``stream_rows(c, FLOW_PLAN)`` rows
    each, the last ragged; the forward's ld partials are (B, this)."""
    return -(-m // stream_rows(c, FLOW_PLAN))


def flow_walk(b: int, m: int, c: int, grid: int) -> list[list[tuple[int, int, int]]]:
    """The tiles each warp of a ``grid``-block stream launch takes, in its
    order, as (batch, first row, end row) within the batch: tile k is
    batch k // T's rows [i R, min(i R + R, m)), i = k % T, T =
    ``flow_tiles_per_batch(m, c)``, R = ``stream_rows(c, FLOW_PLAN)``; warp
    g takes tiles g, g + grid * warps, ...  (the kernel's loop,
    ``stream_tiles``)."""
    r, per = stream_rows(c, FLOW_PLAN), flow_tiles_per_batch(m, c)
    return [[(k // per, k % per * r, min(k % per * r + r, m)) for k in tiles]
            for tiles in stream_tiles(b * per, c, grid, FLOW_PLAN)]


def spine_smem_bytes(c: int, block_m: int) -> int:
    """Shared memory one ``spine_bwd`` block takes: W and W^-1 (2*C*C), the
    channel vectors (3*C) and three tiles (3*block_m*C), in f32
    (``spine_smem_bytes`` in ``flowstep.cu``)."""
    return 4 * (2 * c * c + 3 * c + 3 * block_m * c)


def spine_slab_rows(c: int) -> int:
    """Rows of a cluster-kernel slab at most (``spine_slab_rows`` in
    ``flowstep.cu``): 8 warps of 32 / (C / SPINE_OUT) rows, one row a lane
    group, so one pass of the block's lanes covers the slab."""
    return 8 * 32 // (c // SPINE_OUT)


def spine_path(x2, gx2) -> str:
    """The kernel that computes ``spine_bwd(x2, gx2, ...)``: "cluster" for C
    in ``SPINE_WIDTHS`` with x2 and gx2 16-byte aligned (its 16-byte
    copies), "tile" otherwise."""
    aligned = x2.data_ptr() % 16 == 0 and gx2.data_ptr() % 16 == 0
    return "cluster" if x2.shape[-1] in SPINE_WIDTHS and aligned else "tile"


def spine_plan(n_rows: int, c: int, max_clusters: int) -> dict[str, int]:
    """The cluster kernel's launch, as ``gw_plan`` (``kernels/conv1x1``) is
    conv1x1_gw's: ``clusters`` clusters of ``cluster_size`` blocks; block k
    takes rows [k cta_rows, (k+1) cta_rows), ``slab_rows`` at a time.  No
    more clusters than ``SPINE_PLAN`` names, than the card holds at once
    (``max_clusters``), or than give each block ``SPINE_MIN_ROWS`` rows.
    Row counts are multiples of 8 (whole 8-row steps of the gW product, and
    16-byte aligned slabs in either storage type), and a block's slabs are
    as even as 8 rows allow."""
    round8 = lambda v: -(-v // 8) * 8  # noqa: E731
    cl = SPINE_CLUSTER
    clusters = max(1, min(SPINE_PLAN[c], max_clusters, -(-n_rows // (cl * SPINE_MIN_ROWS))))
    cta_rows = round8(-(-n_rows // (clusters * cl)))
    slab_rows = round8(-(-cta_rows // -(-cta_rows // spine_slab_rows(c))))
    return {"clusters": clusters, "cluster_size": cl, "cta_rows": cta_rows,
            "slab_rows": slab_rows}


def spine_walk(n_rows: int, plan: dict[str, int]) -> list[list[tuple[int, int]]]:
    """The slabs each block of the cluster kernel takes, in its order, as row
    ranges (the kernel's loop): block k's rows are [k cta_rows, (k+1)
    cta_rows) cut at ``n_rows``, ``slab_rows`` at a time."""
    blocks = []
    for k in range(plan["clusters"] * plan["cluster_size"]):
        r0 = min(k * plan["cta_rows"], n_rows)
        r1 = min(r0 + plan["cta_rows"], n_rows)
        blocks.append([(s, min(s + plan["slab_rows"], r1))
                       for s in range(r0, r1, plan["slab_rows"])])
    return blocks


def spine_groups(c: int) -> int:
    """The groups of 8-row steps that gW's products split into
    (``spine_groups`` in ``flowstep.cu``): 8 warps over its 16 x 8 tiles,
    so at C = 12 each of the two tiles takes four warps."""
    tiles = -(-c // 16) * -(-c // 8)
    return 1 if tiles >= 8 else 8 // tiles


def spine_cluster_smem_bytes(c: int, elem_size: int, cl: int) -> int:
    """Shared memory of one cluster-kernel block (``spine_cluster_smem_bytes``
    in ``flowstep.cu``): W^-1, W^T and three channel vectors in f32; two
    stages of x2 and gx2 slabs, the f32 x1 slab and the gx slab, which the
    groups' gW and the 8 warps' column sums then reuse; the inbox of the
    block's share of the C*C + 2*C sums from each of the ``cl`` blocks of
    its cluster."""
    tr = spine_slab_rows(c)
    tail = max((2 * 2 * elem_size + 4 + elem_size) * tr * c,
               4 * (spine_groups(c) * c * c + 8 * 2 * c))
    e = c * c + 2 * c
    return 4 * (2 * c * c + 3 * c) + tail + 4 * cl * -(-e // cl)


_max_clusters: dict[tuple, int] = {}


def spine_max_clusters(device, dtype, c: int) -> int:
    """How many clusters of the cluster kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per device, dtype and C."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    key = (index, dtype, c)
    if key not in _max_clusters:
        n = ctypes.c_int(0)
        raise_on(_fn("spine_max_clusters")(_DTYPES[dtype], c, SPINE_CLUSTER, index,
                                           ctypes.byref(n)), "spine_bwd")
        _max_clusters[key] = max(1, n.value)
    return _max_clusters[key]


def spine_kernels_per_call(path: str, plan: dict[str, int] | None) -> int:
    """CUDA kernels one ``spine_bwd`` call launches: the cluster kernel, and
    the reduce of its clusters' partials where there are several; the tile
    kernel and its reduce."""
    return 1 if path == "cluster" and plan["clusters"] == 1 else 2


def _validate(x, an_log_s, an_b, w, raw, t) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take; returns (B, M, C, ca, block_m),
    block_m the tile kernel's rows a block."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"flow-step kernels take float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, M, C) tensor, got {tuple(x.shape)}")
    b, m, c = x.shape
    ca = raw.shape[-1]
    for name, v in (("raw", raw), ("t", t)):
        if v.dtype != x.dtype or tuple(v.shape) != (b, m, ca) or v.stride(-1) != 1:
            raise ValueError(f"{name} must be ({b}, {m}, {ca}) {x.dtype} with unit channel stride")
    if raw.stride() != t.stride():
        raise ValueError("raw and t must share strides")
    if not 0 < ca <= c or b > 65535:
        raise ValueError(f"unsupported shape B={b}, C={c}, ca={ca}")
    if tuple(w.shape) != (c, c) or tuple(an_log_s.shape) != (c,) or tuple(an_b.shape) != (c,):
        raise ValueError("W must be (C, C) and the actnorm parameters (C,)")
    block_m = max(1, min(m, TILE_ELEMS // c))
    if smem_bytes(c, block_m) > SMEM_LIMIT:
        raise ValueError(f"C={c}: W and a tile do not fit in {SMEM_LIMIT} bytes of shared memory")
    return b, m, c, ca, block_m


def _params(an_log_s, an_b, w) -> list[torch.Tensor]:
    """The f32 channel parameters and W, contiguous, as the tile kernels
    read them."""
    return [v.to(torch.float32).contiguous() for v in (an_log_s, an_b, w)]


def _check(x, an_log_s, an_b, w, raw, t):
    """Validate the kernel's inputs; returns (B, M, C, ca, block_m) and
    :func:`_params`."""
    return _validate(x, an_log_s, an_b, w, raw, t), _params(an_log_s, an_b, w)


def _stream(inverse: int, x, an_log_s, an_b, w, raw, out, partial, ld, clamp) -> int:
    """Launch the stream (``flowstep_stream`` in ``flowstep.cu``); W (or
    W^-1) is read through its strides."""
    b, m, c = x.shape
    ls, ab = (v.to(torch.float32).contiguous() for v in (an_log_s, an_b))
    w32 = w.to(torch.float32)
    return _fn("flowstep_stream")(
        _DTYPES[x.dtype], inverse, x.data_ptr(), ls.data_ptr(), ab.data_ptr(), w32.data_ptr(),
        w32.stride(0), w32.stride(1), raw.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), None if ld is None else ld.data_ptr(),
        b, m, c, clamp, x.device.index, stream(x),
    )


class _FlowstepFwd(PathKernel):
    def __call__(self, x, an_log_s, an_b, w, raw, t, clamp: float = 2.0):
        """x: (B, M, C); an_*: (C,); w: (C, C); raw, t: (B, M, ca)
        -> (y: (B, M, C) in x's dtype, ld_coupling: (B,) f32)."""
        b, m, c, ca, block_m = _validate(x, an_log_s, an_b, w, raw, t)
        path = flowstep_path(x, raw, t)
        n_tiles = flow_tiles_per_batch(m, c) if path == "stream" else -(-m // block_m)
        y = torch.empty_like(x)
        partial = torch.empty((b, n_tiles), dtype=torch.float32, device=x.device)
        ld = torch.empty((b,), dtype=torch.float32, device=x.device)
        if path == "stream":
            err = _stream(0, x, an_log_s, an_b, w, raw, y, partial, ld, clamp)
        else:
            ls, ab, w32 = _params(an_log_s, an_b, w)
            err = _fn("flowstep_fwd")(
                _DTYPES[x.dtype], x.data_ptr(), ls.data_ptr(), ab.data_ptr(),
                w32.data_ptr(), raw.data_ptr(), t.data_ptr(), raw.stride(0),
                raw.stride(1), y.data_ptr(), partial.data_ptr(), ld.data_ptr(),
                b, m, c, ca, block_m, clamp, x.device.index, stream(x),
            )
        self.count(err, path)
        return y, ld


class _FlowstepInv(PathKernel):
    def __call__(self, y, an_log_s, an_b, w_inv, raw, t, clamp: float = 2.0):
        """Inverse flow step given ``W^-1``: (B, M, C) -> (B, M, C)."""
        b, m, c, ca, block_m = _validate(y, an_log_s, an_b, w_inv, raw, t)
        path = flowstep_path(y, raw, t)
        x = torch.empty_like(y)
        if path == "stream":
            err = _stream(1, y, an_log_s, an_b, w_inv, raw, x, None, None, clamp)
        else:
            ls, ab, wi32 = _params(an_log_s, an_b, w_inv)
            err = _fn("flowstep_inv")(
                _DTYPES[y.dtype], y.data_ptr(), ls.data_ptr(), ab.data_ptr(),
                wi32.data_ptr(), raw.data_ptr(), t.data_ptr(), raw.stride(0),
                raw.stride(1), x.data_ptr(), b, m, c, ca, block_m, clamp, y.device.index,
                stream(y),
            )
        self.count(err, path)
        return x


class _SpineBwd(PathKernel):

    def __call__(self, x2, gx2, w, w_inv, an_log_s, an_b):
        """x2, gx2: (B, M, C) -> (x, gx: (B, M, C) in x2's dtype, gW: (C, C),
        g_log_s, g_b: (C,), all three f32)."""
        if x2.dtype not in _DTYPES:
            raise TypeError(f"spine_bwd takes float32 or bfloat16, got {x2.dtype}")
        if x2.ndim != 3 or not x2.is_contiguous():
            raise ValueError(f"x2 must be a contiguous (B, M, C) tensor, got {tuple(x2.shape)}")
        if gx2.dtype != x2.dtype or gx2.shape != x2.shape or not gx2.is_contiguous():
            raise ValueError(f"gx2 must be a contiguous {tuple(x2.shape)} {x2.dtype} tensor")
        b, m, c = x2.shape
        if b > 65535:
            raise ValueError(f"unsupported batch B={b}")
        if (tuple(w.shape) != (c, c) or tuple(w_inv.shape) != (c, c)
                or tuple(an_log_s.shape) != (c,) or tuple(an_b.shape) != (c,)):
            raise ValueError("W and W^-1 must be (C, C) and the actnorm parameters (C,)")
        ls, ab = (v.to(torch.float32).contiguous() for v in (an_log_s, an_b))
        w32, wi32 = w.to(torch.float32), w_inv.to(torch.float32)
        x = torch.empty_like(x2)
        gx = torch.empty_like(x2)
        sums = torch.empty((c * c + 2 * c,), dtype=torch.float32, device=x2.device)
        path = spine_path(x2, gx2)
        if path == "cluster":  # W and W^-1 read through their strides
            plan = spine_plan(b * m, c, spine_max_clusters(x2.device, x2.dtype, c))
            partial = (None if plan["clusters"] == 1 else
                       torch.empty((plan["clusters"], c * c + 2 * c), dtype=torch.float32,
                                   device=x2.device))
            strides = (ctypes.c_longlong * 4)(*w32.stride(), *wi32.stride())
            err = _fn("spine_bwd_cluster")(
                _DTYPES[x2.dtype], x2.data_ptr(), gx2.data_ptr(), w32.data_ptr(),
                wi32.data_ptr(), strides, ls.data_ptr(), ab.data_ptr(), x.data_ptr(), gx.data_ptr(),
                None if partial is None else partial.data_ptr(), sums.data_ptr(), b * m, c,
                plan["cta_rows"], plan["slab_rows"], plan["clusters"], plan["cluster_size"],
                x2.device.index, stream(x2),
            )
        else:
            block_m = max(1, min(m, TILE_ELEMS // c))
            if spine_smem_bytes(c, block_m) > SMEM_LIMIT:
                raise ValueError(f"C={c}: W, W^-1 and the tiles do not fit in {SMEM_LIMIT} bytes "
                                 "of shared memory")
            n_blocks = b * -(-m // block_m)
            partial = torch.empty((n_blocks, c * c + 2 * c), dtype=torch.float32,
                                  device=x2.device)
            w32, wi32 = w32.contiguous(), wi32.contiguous()
            err = _fn("spine_bwd")(
                _DTYPES[x2.dtype], x2.data_ptr(), gx2.data_ptr(), w32.data_ptr(),
                wi32.data_ptr(), ls.data_ptr(), ab.data_ptr(), x.data_ptr(), gx.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), b, m, c, block_m, x2.device.index,
                stream(x2),
            )
        self.count(err, path)
        return x, gx, sums[: c * c].view(c, c), sums[c * c: c * c + c], sums[c * c + c:]


flowstep_fwd = _FlowstepFwd("flowstep_fwd", FLOW_PATHS)
flowstep_inv = _FlowstepInv("flowstep_inv", FLOW_PATHS)
spine_bwd = _SpineBwd("spine_bwd", SPINE_PATHS)
KERNELS = (flowstep_fwd, flowstep_inv, spine_bwd)
