"""Bindings of the hand-written CUDA affine coupling (``csrc/coupling.cu``).

``coupling_fwd``, ``coupling_inv`` and ``coupling_bwd`` replace the Pallas
kernels of the same names in ``repro/kernels/coupling/coupling.py``.  All
three are memory-bound (16 bytes an element in f32 for the forward and the
inverse, 32 for the backward); the source note in ``coupling.cu`` gives the
design.  Each wrapper checks what the kernel takes, allocates the outputs,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its ``launches`` count and to the path's in ``launches_by_path``.

Two contracts.  Called as ``coupling_fwd(x, raw, t)`` / ``coupling_inv(y,
raw, t)``, the half kernels (the "tile" path) take (B, M, ca) views with
unit channel stride and any row and batch strides (the halves of a (B, M, C)
tensor); ``raw`` and ``t`` share theirs.  Outputs are contiguous (B, M, ca)
in the input's dtype.  Called as ``coupling_fwd.rows(x, h, flip)`` /
``coupling_inv.rows(y, h, flip)``, they compute the coupling layer's whole
(B, M, C) output from its whole input and conditioner output: on the row
stream where :func:`coupling_path` allows it ("rows"), else on the half
kernel, whose half is then joined to the pass-through half ("tile"); an h
of width 2 C makes all of x the transformed half (:func:`row_halves`).
``coupling_bwd(y, raw, t, gy, gld)`` is the backward's half kernel, and
``coupling_bwd.rows(y, h, gy, gld, flip)`` the backward's whole rows ``(x,
gx, gh)``: x the layer's input row, gx the cotangent of x with the
pass-through half's taken as gy's (the caller adds the conditioner's), gh the
cotangent of h, ``(graw | gt)``; on the backward's row stream where
:func:`coupling_path` allows it, else the half kernel and the joins.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, STREAM_WIDTHS, PathKernel, bind, stream

#: elements of one batch row a ``coupling_fwd`` block owns (8 a thread)
TILE_ELEMS = 2048
#: what ``launches_by_path`` counts: the row stream and the half kernels
COUPLING_PATHS = ("rows", "tile")
#: the row stream's lane layout at every width (``COUPLING_PLAN`` in
#: ``coupling.cu``): (coupled columns, rows) a lane computes, warps a block
COUPLING_PLAN = (6, 1, 8)
#: CUDA kernels one call launches, on either path: the coupling's kernel and,
#: forward, the fixed-order sum of its tiles' ld partials (``coupling_bwd``
#: launches one)
KERNELS_PER_CALL = {"coupling_fwd": 2, "coupling_inv": 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "coupling_fwd": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "coupling_inv": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _I, _I, _I, _F, _I, _P],
    "coupling_bwd": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P,
                     _I, _I, _I, _F, _I, _P],
    "coupling_rows": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "coupling_bwd_rows": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
}


def _fn(name: str):
    return bind("coupling", name, _SIGNATURES[name])


def _check(name, v, raw, t, *more):
    """Validate ``v`` (x or y), ``raw``, ``t`` and any further (B, M, ca)
    operands; returns (B, M, ca)."""
    if v.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {v.dtype}")
    if v.ndim != 3 or v.numel() == 0:
        raise ValueError(f"{name}: operands must be non-empty (B, M, ca), got {tuple(v.shape)}")
    for what, u in (("raw", raw), ("t", t), *more, ("input", v)):
        if u.dtype != v.dtype or u.shape != v.shape or u.stride(-1) != 1:
            raise ValueError(f"{name}: {what} must be {tuple(v.shape)} {v.dtype} "
                             "with unit channel stride")
    if raw.stride() != t.stride():
        raise ValueError(f"{name}: raw and t must share strides")
    b, m, ca = v.shape
    if b > 65535:
        raise ValueError(f"{name}: unsupported batch B={b}")
    return b, m, ca


def coupling_rows_per_tile(c: int) -> int:
    """Rows of a row-stream tile (``coupling_rows_per_tile`` in
    ``coupling.cu``): each lane takes ``k`` coupled columns of ``rpl`` rows,
    so ``(c // 2) // k`` lanes share a group of ``rpl`` rows."""
    k, rpl, _ = COUPLING_PLAN
    return rpl * 32 // (c // 2 // k)


def coupling_tiles_per_batch(m: int, c: int) -> int:
    """The row stream's tiles of one batch, the last ragged; the forward's ld
    partials are (B, this)."""
    return -(-m // coupling_rows_per_tile(c))


def coupling_walk(b: int, m: int, c: int, grid: int) -> list[list[tuple[int, int, int]]]:
    """The tiles each warp of a ``grid``-block row-stream launch takes, in its
    order, as (batch, first row, end row) within the batch: tile k is batch
    k // T's rows [i R, min(i R + R, m)), i = k % T, T =
    ``coupling_tiles_per_batch(m, c)``, R = ``coupling_rows_per_tile(c)``;
    warp g takes tiles g, g + grid * warps, ...  (``RowWalk`` in
    ``row_stream.cuh``)."""
    r, per = coupling_rows_per_tile(c), coupling_tiles_per_batch(m, c)
    step = grid * COUPLING_PLAN[2]
    return [[(k // per, k % per * r, min(k % per * r + r, m)) for k in range(g, b * per, step)]
            for g in range(step)]


def coupling_rows_smem_bytes(c: int, elem_size: int, staged: int = 2) -> int:
    """Shared memory of one row-stream block: each warp's 2-stage ring of
    ``staged`` tiles in the storage type, (x | h) for the forward and the
    inverse, (y | h | gy) for the backward (``staged=3``)."""
    return COUPLING_PLAN[2] * 2 * staged * coupling_rows_per_tile(c) * c * elem_size


def coupling_bwd_rows_smem_bytes(c: int, elem_size: int) -> int:
    """Shared memory of one backward row-stream block (y | h | gy)."""
    return coupling_rows_smem_bytes(c, elem_size, staged=3)


def coupling_path(x, raw, t, flip: bool = False, gy=None) -> str:
    """The kernel that computes the coupling layer's output from its input x
    (the output y for the inverse and the backward), (B, M, C), and the
    conditioner's raw and t: "rows" (the row stream) for C = 2 ca in
    ``STREAM_WIDTHS`` when the first half is the coupled one (no ``flip``),
    x is contiguous, raw and t are the two halves of one contiguous (B, M, C)
    tensor (``t`` starts ca elements after ``raw``, rows C apart), as the
    layer passes its conditioner output, and x, raw and each batch's rows
    (M*C elements) are 16-byte aligned (its 16-byte copies); for the
    backward, the row cotangent ``gy`` too is a contiguous (B, M, C) tensor
    of x's dtype on a 16-byte boundary; "tile" (the half kernel)
    otherwise."""
    b, m, c = x.shape
    ca, es = raw.shape[-1], x.element_size()
    halves = (2 * ca == c and raw.dtype == t.dtype == x.dtype
              and raw.stride() == t.stride() == (m * c, c, 1)
              and t.data_ptr() == raw.data_ptr() + ca * es)
    aligned = (x.data_ptr() % 16 == 0 and raw.data_ptr() % 16 == 0
               and (b == 1 or m * c * es % 16 == 0))
    cotangent = gy is None or (gy.shape == x.shape and gy.dtype == x.dtype
                               and gy.is_contiguous() and gy.data_ptr() % 16 == 0)
    return ("rows" if not flip and c in STREAM_WIDTHS and x.is_contiguous() and halves
            and aligned and cotangent else "tile")


def row_halves(v, h, flip: bool = False):
    """The coupling layer's split of a (B, M, C) row tensor ``v`` and its
    (B, M, 2 n) conditioner output ``h``: (transformed half (B, M, n),
    pass-through half, raw, t).  The transformed half is the first n = C // 2
    columns, or the last n = C - C // 2 with ``flip``, as
    ``AffineCoupling._split`` takes them; or, n = C, the whole of ``v``, and
    the pass-through half is empty (the half contract)."""
    c, s = v.shape[-1], v.shape[-1] // 2
    n = c - s if flip else s
    if h.shape[:-1] != v.shape[:-1] or h.shape[-1] not in (2 * n, 2 * c):
        raise ValueError(f"h must be {(*v.shape[:-1], 2 * n)} or {(*v.shape[:-1], 2 * c)} "
                         f"for rows {tuple(v.shape)}, got {tuple(h.shape)}")
    if h.shape[-1] == 2 * c:
        s, n = (0, c) if flip else (c, c)
    va, vb = (v[..., s:], v[..., :s]) if flip else (v[..., :s], v[..., s:])
    return va, vb, h[..., :n], h[..., n:]


def join_rows(va, vb, flip: bool = False):
    """The layer's output row from its transformed half ``va`` and its
    pass-through half ``vb`` (``AffineCoupling._merge``); ``va`` itself when
    ``vb`` is empty."""
    if vb.shape[-1] == 0:
        return va
    return torch.cat([vb, va] if flip else [va, vb], dim=-1)


def unit_channels(v, raw, t):
    """``(v, raw, t)`` in a layout the half kernels take: unit channel
    stride, and ``raw``/``t`` sharing strides."""
    if v.stride(-1) != 1:
        v = v.contiguous()
    if raw.stride(-1) != 1 or raw.stride() != t.stride():
        raw, t = raw.contiguous(), t.contiguous()
    return v, raw, t


def _check_rows(name, v, h, *more):
    """Validate the row op's rows ``v``, its h and any further (B, M, C)
    operands (the backward's gy) before any library is loaded."""
    if v.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {v.dtype}")
    if v.ndim != 3 or v.numel() == 0:
        raise ValueError(f"{name}: rows must be non-empty (B, M, C), got {tuple(v.shape)}")
    for what, u in (("h", h), *more):
        if u.device != v.device:
            raise ValueError(f"{name}: rows on {v.device}, {what} on {u.device}")
    for what, u in more:
        if u.shape != v.shape or u.dtype != v.dtype:
            raise ValueError(f"{name}: {what} must be {tuple(v.shape)} {v.dtype}, got "
                             f"{tuple(u.shape)} {u.dtype}")


def _rows(kernel, inverse: int, v, h, flip, clamp):
    """The row op on the card: the row stream where :func:`coupling_path`
    allows it, else ``kernel``'s half kernel and the join.  Returns (out,
    ld or None)."""
    _check_rows(kernel.name, v, h)
    va, vb, raw, t = row_halves(v, h, flip)
    if coupling_path(v, raw, t, flip) == "tile":
        out = kernel(*unit_channels(va, raw, t), clamp)
        va, ld = (out, None) if inverse else out
        return join_rows(va, vb, flip), ld
    b, m, c = v.shape
    out = torch.empty_like(v)
    partial = ld = None
    if not inverse:
        partial = torch.empty((b, coupling_tiles_per_batch(m, c)), dtype=torch.float32,
                              device=v.device)
        ld = torch.empty((b,), dtype=torch.float32, device=v.device)
    err = _fn("coupling_rows")(
        KERNEL_DTYPES[v.dtype], inverse, v.data_ptr(), raw.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), None if ld is None else ld.data_ptr(),
        b, m, c, clamp, v.device.index, stream(v),
    )
    kernel.count(err, "rows")
    return out, ld


class _CouplingFwd(PathKernel):
    def __call__(self, x, raw, t, clamp: float = 2.0):
        """x, raw, t: (B, M, ca) -> (y: contiguous (B, M, ca) in x's dtype,
        ld: (B,) f32, the sum of log_s over (m, j)), on the half kernel."""
        b, m, ca = _check(self.name, x, raw, t)
        n_tiles = -(-(m * ca) // TILE_ELEMS)
        y = torch.empty((b, m, ca), dtype=x.dtype, device=x.device)
        partial = torch.empty((b, n_tiles), dtype=torch.float32, device=x.device)
        ld = torch.empty((b,), dtype=torch.float32, device=x.device)
        err = _fn("coupling_fwd")(
            KERNEL_DTYPES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), raw.data_ptr(),
            t.data_ptr(), raw.stride(0), raw.stride(1), y.data_ptr(), partial.data_ptr(),
            ld.data_ptr(), b, m, ca, TILE_ELEMS, clamp, x.device.index, stream(x),
        )
        self.count(err, "tile")
        return y, ld

    def rows(self, x, h, flip: bool = False, clamp: float = 2.0):
        """x: (B, M, C), h: its conditioner output (B, M, 2 n), n the
        transformed width -> (y: contiguous (B, M, C) in x's dtype, the
        layer's whole output row, ld: (B,) f32)."""
        return _rows(self, 0, x, h, flip, clamp)


class _CouplingInv(PathKernel):
    def __call__(self, y, raw, t, clamp: float = 2.0):
        """y, raw, t: (B, M, ca) -> x: contiguous (B, M, ca) in y's dtype, on
        the half kernel."""
        b, m, ca = _check(self.name, y, raw, t)
        x = torch.empty((b, m, ca), dtype=y.dtype, device=y.device)
        err = _fn("coupling_inv")(
            KERNEL_DTYPES[y.dtype], y.data_ptr(), y.stride(0), y.stride(1), raw.data_ptr(),
            t.data_ptr(), raw.stride(0), raw.stride(1), x.data_ptr(), b, m, ca, clamp,
            y.device.index, stream(y),
        )
        self.count(err, "tile")
        return x

    def rows(self, y, h, flip: bool = False, clamp: float = 2.0):
        """y: (B, M, C), h: the conditioner output of its pass-through half
        (B, M, 2 n) -> x: contiguous (B, M, C) in y's dtype."""
        return _rows(self, 1, y, h, flip, clamp)[0]


class _CouplingBwd(PathKernel):
    def __call__(self, y, raw, t, gy, gld, clamp: float = 2.0):
        """y, raw, t, gy: (B, M, ca); gld: (B,) -> (x, gx, graw, gt),
        contiguous (B, M, ca) in y's dtype, on the half kernel."""
        b, m, ca = _check(self.name, y, raw, t, ("gy", gy))
        if tuple(gld.shape) != (b,):
            raise ValueError(f"gld must be ({b},), got {tuple(gld.shape)}")
        gld32 = gld.to(torch.float32).contiguous()
        x, gx, graw, gt = (torch.empty((b, m, ca), dtype=y.dtype, device=y.device)
                           for _ in range(4))
        err = _fn("coupling_bwd")(
            KERNEL_DTYPES[y.dtype], y.data_ptr(), y.stride(0), y.stride(1), raw.data_ptr(),
            t.data_ptr(), raw.stride(0), raw.stride(1), gy.data_ptr(), gy.stride(0),
            gy.stride(1), gld32.data_ptr(), x.data_ptr(), gx.data_ptr(), graw.data_ptr(),
            gt.data_ptr(), b, m, ca, clamp, y.device.index, stream(y),
        )
        self.count(err, "tile")
        return x, gx, graw, gt

    def rows(self, y, h, gy, gld, flip: bool = False, clamp: float = 2.0):
        """y, gy: (B, M, C), the layer's output row and its cotangent; h:
        the conditioner output (B, M, 2 n); gld: (B,) -> (x, gx, gh): x the
        layer's input row, gx the cotangent of x with gy's pass-through half
        (the caller adds the conditioner's cotangent into it), both (B, M,
        C), and gh the cotangent of h, (graw | gt) in h's layout; each
        contiguous in y's dtype."""
        _check_rows(self.name, y, h, ("gy", gy))
        b, m, c = y.shape
        if tuple(gld.shape) != (b,):
            raise ValueError(f"gld must be ({b},), got {tuple(gld.shape)}")
        ya, yb, raw, t = row_halves(y, h, flip)
        if coupling_path(y, raw, t, flip, gy) == "tile":
            gya, gyb, _, _ = row_halves(gy, h, flip)
            ya, raw, t = unit_channels(ya, raw, t)
            xa, gxa, graw, gt = self(ya, raw, t, gya if gya.stride(-1) == 1 else gya.contiguous(),
                                     gld, clamp)
            return (join_rows(xa, yb, flip), join_rows(gxa, gyb.to(gxa.dtype), flip),
                    torch.cat([graw, gt], dim=-1))
        gld32 = gld.to(torch.float32).contiguous()
        x, gx, gh = (torch.empty_like(y) for _ in range(3))
        err = _fn("coupling_bwd_rows")(
            KERNEL_DTYPES[y.dtype], y.data_ptr(), raw.data_ptr(), gy.data_ptr(),
            gld32.data_ptr(), x.data_ptr(), gx.data_ptr(), gh.data_ptr(), b, m, c, clamp,
            y.device.index, stream(y),
        )
        self.count(err, "rows")
        return x, gx, gh


coupling_fwd = _CouplingFwd("coupling_fwd", COUPLING_PATHS)
coupling_inv = _CouplingInv("coupling_inv", COUPLING_PATHS)
coupling_bwd = _CouplingBwd("coupling_bwd", COUPLING_PATHS)
KERNELS = (coupling_fwd, coupling_inv, coupling_bwd)
