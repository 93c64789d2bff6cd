"""Bindings of the hand-written CUDA 1x1-convolution kernels
(``csrc/conv1x1.cu``).

``conv1x1_mm`` and ``conv1x1_gw`` replace the Pallas kernels of the same
names in ``repro/kernels/conv1x1/conv1x1.py``.  Both are memory-bound at the
widths GLOW uses (12 bytes an element in f32 for the product, 8 for the
weight cotangent); the source note in ``conv1x1.cu`` gives the design.
``conv1x1_mm`` has two kernels, chosen by a shape rule (:func:`mm_path`):
the persistent stream at the GLOW widths, the W-panel kernel at any other.
Each wrapper checks what the kernel takes, allocates the outputs and
scratch, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its ``launches`` count (``conv1x1_mm`` also to the
path's in ``launches_by_path``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (STREAM_PLAN, STREAM_WIDTHS, KERNEL_DTYPES, PathKernel,
                                        bind, stream, stream_rows, stream_tiles)

#: shared memory a block may take without opting in to more
SMEM_LIMIT = 48 * 1024
#: x elements a ``conv1x1_mm`` block (and a ``conv1x1_gw`` slab) stages
TILE_ELEMS = 2048
#: W elements a ``conv1x1_mm`` block stages: a panel of PANEL_ELEMS // C columns
PANEL_ELEMS = 8192
#: threads of a block, and the gW entries each ``conv1x1_gw`` thread keeps
THREADS, GW_TILE_ENTRIES = 256, 16
#: ``conv1x1_gw``'s cluster kernel at each stream width and element size:
#: the columns of x (rows of gW) a slice takes (a template instance each,
#: ``launch_gw_cluster_c`` in ``conv1x1.cu``), the clusters of each slice at
#: most, the blocks of a cluster.  The fastest of ``tools/gw_plan_sweep.py``
#: on the H100 (``PERF.md``): C = 12 and 24 are bound by bytes and take
#: every SM, a partial per block and the fixed-order reduce; at C = 48 bf16
#: three slices of one 16-block cluster each sum in one launch, f32 needs 4
#: clusters a slice for its bytes
GW_PLAN = {(12, 4): (12, 128, 1), (12, 2): (12, 128, 1), (24, 4): (24, 128, 1),
           (24, 2): (24, 128, 1), (48, 4): (16, 4, 8), (48, 2): (16, 1, 16)}
#: the bytes of x and gy a block stages at a time, the stages of its ring
#: (``kGwStages``), the fewest rows worth another cluster, and the shared
#: memory a block may opt in to on the card
GW_STAGE_BYTES, GW_STAGES, GW_MIN_ROWS, SMEM_OPT_IN = 49152, 4, 64, 232448
#: what launches_by_path counts, for each kernel
PATHS = {"conv1x1_mm": ("stream", "panel"), "conv1x1_gw": ("cluster", "panel")}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "conv1x1_mm": [_I, _P, _P, _L, _L, _P, _L, _I, _I, _I, _I, _P],
    "conv1x1_gw": [_I, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P],
    "conv1x1_mm_stream": [_I, _P, _P, _L, _L, _P, _L, _I, _I, _P],
    "conv1x1_gw_cluster": [_I, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I, _I, _P],
}


def _fn(name: str):
    return bind("conv1x1", name, _SIGNATURES[name])


def mm_smem_bytes(c: int, block_m: int, panel: int) -> int:
    """Shared memory of one ``conv1x1_mm`` block: a (C, panel) panel of W and
    a (block_m, C) tile of x, in f32 (``mm_smem_bytes`` in ``conv1x1.cu``)."""
    return 4 * (c * panel + block_m * c)


def mm_path(x) -> str:
    """The kernel that computes ``conv1x1_mm(x, W)``: "stream" for
    C in ``STREAM_WIDTHS`` and a 16-byte-aligned x (its 16-byte copies),
    "panel" otherwise."""
    return "stream" if x.shape[-1] in STREAM_WIDTHS and x.data_ptr() % 16 == 0 else "panel"


def stream_smem_bytes(c: int, elem_size: int) -> int:
    """Shared memory of one stream block (``mm_stream_smem_bytes`` in
    ``conv1x1.cu``): W in f32 and each warp's 2-stage ring of x tiles."""
    return 4 * c * c + STREAM_PLAN[c][2] * 2 * stream_rows(c) * c * elem_size


def stream_walk(n_rows: int, c: int, grid: int) -> list[list[tuple[int, int]]]:
    """The row ranges each warp of a ``grid``-block stream launch takes, in
    its order: tile t is rows [t R, min(t R + R, n_rows)), and warp g takes
    tiles g, g + grid * warps, ...  (the kernel's loop, ``stream_tiles``)."""
    r = stream_rows(c)
    return [[(t * r, min(t * r + r, n_rows)) for t in tiles]
            for tiles in stream_tiles(-(-n_rows // r), c, grid)]


def gw_smem_bytes(c: int, stage_rows: int) -> int:
    """Shared memory of one ``conv1x1_gw`` block: slabs of x and gy and the
    row groups' sums, in f32 (``gw_smem_bytes`` in ``conv1x1.cu``)."""
    return 4 * (2 * stage_rows * c + THREADS * GW_TILE_ENTRIES)


def gw_path(x, gy) -> str:
    """The kernel that computes ``conv1x1_gw(x, gy)``: "cluster" for C in
    ``STREAM_WIDTHS`` with x and gy 16-byte aligned (its 16-byte copies),
    "panel" otherwise."""
    aligned = x.data_ptr() % 16 == 0 and gy.data_ptr() % 16 == 0
    return "cluster" if x.shape[-1] in STREAM_WIDTHS and aligned else "panel"


def gw_plan(n_rows: int, c: int, elem_size: int, n_sm: int) -> dict[str, int]:
    """The cluster kernel's launch (``GW_PLAN``): ``c // xw`` slices of gW's
    rows, each ``clusters`` clusters of ``cluster_size`` blocks; block k of a
    slice sums rows [k cta_rows, (k+1) cta_rows), ``slab_rows`` at a time.
    Fewer clusters where each would get under ``GW_MIN_ROWS`` rows a block,
    and no more blocks than SMs.  Row counts are multiples of 8, so every slab
    of either storage type starts 16-byte aligned."""
    xw, most, cl = GW_PLAN[c, elem_size]
    slices = c // xw
    clusters = max(1, min(most, n_sm // (slices * cl), -(-n_rows // (cl * GW_MIN_ROWS))))
    cta_rows, slab_rows = gw_rows(n_rows, c, elem_size, xw, clusters * cl)
    return {"xw": xw, "slices": slices, "clusters": clusters, "cluster_size": cl,
            "cta_rows": cta_rows, "slab_rows": slab_rows}


def gw_rows(n_rows: int, c: int, elem_size: int, xw: int, blocks: int) -> tuple[int, int]:
    """The rows of each of a slice's ``blocks`` blocks and of its slabs: both
    multiples of 8, a slab of x's ``xw`` columns and of gy at most
    ``GW_STAGE_BYTES``, a block's slabs as even as 8 rows allow."""
    round8 = lambda v: -(-v // 8) * 8  # noqa: E731
    cta_rows = round8(-(-n_rows // blocks))
    cap = max(8, GW_STAGE_BYTES // ((xw + c) * elem_size) // 8 * 8)
    return cta_rows, round8(-(-cta_rows // -(-cta_rows // cap)))


def gw_walk(n_rows: int, plan: dict[str, int]) -> list[list[tuple[int, int]]]:
    """The slabs each block of a slice sums, in its order, as row ranges (the
    kernel's loop): block k's rows are [k cta_rows, (k+1) cta_rows) cut at
    ``n_rows``, ``slab_rows`` at a time.  Every slice walks the same rows."""
    blocks = []
    for k in range(plan["clusters"] * plan["cluster_size"]):
        r0 = min(k * plan["cta_rows"], n_rows)
        r1 = min(r0 + plan["cta_rows"], n_rows)
        blocks.append([(s, min(s + plan["slab_rows"], r1))
                       for s in range(r0, r1, plan["slab_rows"])])
    return blocks


def gw_cluster_smem_bytes(c: int, xw: int, slab_rows: int, elem_size: int, cl: int) -> int:
    """Shared memory of one cluster-kernel block (``gw_cluster_smem_bytes``
    in ``conv1x1.cu``): the ring of x-slice and gy slabs, which the 8 warps'
    (xw, C) sums then reuse; the block's (xw, C) sum; the inbox of its share
    of them from each of the ``cl`` blocks of its cluster, in f32."""
    ring = max(GW_STAGES * slab_rows * (xw + c) * elem_size, 4 * 8 * xw * c)
    return ring + 4 * (xw * c + cl * -(-(xw * c) // cl))


def gw_chunks(n_rows: int, c: int, elem_size: int, n_sm: int) -> int:
    """The row chunks ``conv1x1_gw`` sums separately: two per SM, but no more
    than keeps the chunks' (C, C) f32 partials under a quarter of the inputs'
    bytes (``n * C*C*4 <= n_rows * 2*C*elem_size / 4``), so the partials and
    their reduce stay small next to the pass over x and gy."""
    cap = (n_rows * elem_size) // (8 * c)
    return max(1, min(2 * n_sm, cap, n_rows))


def _check(name, x, other, what):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a non-empty contiguous (B, M, C) tensor, "
                         f"got {tuple(x.shape)}")
    if other is not None and (other.dtype != x.dtype or other.shape != x.shape
                              or not other.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous {tuple(x.shape)} {x.dtype} tensor")
    return x.shape


class _Conv1x1Mm(PathKernel):
    def __call__(self, x, w):
        """x: (B, M, C); w: (C, C), any strides and float dtype (rounded to
        x's dtype first) -> y: (B, M, C) in x's dtype."""
        b, m, c = _check(self.name, x, None, "")
        if tuple(w.shape) != (c, c) or w.device != x.device:
            raise ValueError(f"{self.name}: W must be ({c}, {c}) on {x.device}")
        w = w.to(x.dtype)
        n = b * m
        path = mm_path(x)
        y = torch.empty_like(x)
        if path == "stream":
            err = _fn("conv1x1_mm_stream")(
                KERNEL_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
                y.data_ptr(), n, c, x.device.index, stream(x),
            )
        else:
            block_m = max(1, min(n, TILE_ELEMS // c))
            panel = max(1, min(c, PANEL_ELEMS // c))
            if mm_smem_bytes(c, block_m, panel) > SMEM_LIMIT:
                raise ValueError(f"{self.name}: C={c} does not fit in {SMEM_LIMIT} bytes of "
                                 "shared memory")
            err = _fn(self.name)(
                KERNEL_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
                y.data_ptr(), n, c, block_m, panel, x.device.index, stream(x),
            )
        self.count(err, path)
        return y


class _Conv1x1Gw(PathKernel):
    def __call__(self, x, gy):
        """x, gy: (B, M, C) -> gW: (C, C) f32, ``sum_{b,m} x^T gy``."""
        b, m, c = _check(self.name, x, gy, "gy")
        n = b * m
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        path = gw_path(x, gy)
        gw = torch.empty((c, c), dtype=torch.float32, device=x.device)
        if path == "cluster":
            plan = gw_plan(n, c, x.element_size(), n_sm)
            partial = (None if plan["clusters"] == 1 else
                       torch.empty((plan["clusters"], c * c), dtype=torch.float32,
                                   device=x.device))
            err = _fn("conv1x1_gw_cluster")(
                KERNEL_DTYPES[x.dtype], x.data_ptr(), gy.data_ptr(),
                None if partial is None else partial.data_ptr(), gw.data_ptr(), n, c,
                plan["xw"], plan["cta_rows"], plan["slab_rows"], plan["clusters"],
                plan["cluster_size"], x.device.index, stream(x),
            )
        else:
            err = self._panel(x, gy, gw, n, c, n_sm)
        self.count(err, path)
        return gw

    def _panel(self, x, gy, gw, n, c, n_sm) -> int:
        chunk_rows = -(-n // gw_chunks(n, c, x.element_size(), n_sm))
        n_chunks = -(-n // chunk_rows)
        stage_rows = max(1, min(chunk_rows, TILE_ELEMS // c))
        if gw_smem_bytes(c, stage_rows) > SMEM_LIMIT:
            raise ValueError(f"{self.name}: C={c} does not fit in {SMEM_LIMIT} bytes of "
                             "shared memory")
        partial = torch.empty((n_chunks, c * c), dtype=torch.float32, device=x.device)
        return _fn(self.name)(
            KERNEL_DTYPES[x.dtype], x.data_ptr(), gy.data_ptr(), partial.data_ptr(),
            gw.data_ptr(), n, c, chunk_rows, stage_rows, x.device.index, stream(x),
        )


conv1x1_mm = _Conv1x1Mm("conv1x1_mm", PATHS["conv1x1_mm"])
conv1x1_gw = _Conv1x1Gw("conv1x1_gw", PATHS["conv1x1_gw"])
KERNELS = (conv1x1_mm, conv1x1_gw)
