"""Bindings of the hand-written CUDA affine coupling (``csrc/coupling.cu``).

``coupling_fwd``, ``coupling_inv`` and ``coupling_bwd`` replace the Pallas
kernels of the same names in ``repro/kernels/coupling/coupling.py``.  All
three are memory-bound (16 bytes an element in f32 for the forward and the
inverse, 32 for the backward); the source note in ``coupling.cu`` gives the
design.  Each wrapper checks what the kernel takes, allocates the outputs,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its ``launches`` count.

Inputs are (B, M, ca) views with unit channel stride and any row and batch
strides (the halves of a (B, M, C) tensor); ``raw`` and ``t`` share theirs.
Outputs are contiguous (B, M, ca) in the input's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: elements of one batch row a ``coupling_fwd`` block owns (8 a thread)
TILE_ELEMS = 2048

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "coupling_fwd": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "coupling_inv": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _I, _I, _I, _F, _I, _P],
    "coupling_bwd": [_I, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P,
                     _I, _I, _I, _F, _I, _P],
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


class _CouplingFwd(Kernel):
    def __call__(self, x, raw, t, clamp: float = 2.0):
        """x, raw, t: (B, M, ca) -> (y: contiguous (B, M, ca) in x's dtype,
        ld: (B,) f32, the sum of log_s over (m, j))."""
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
        raise_on(err, self.name)
        self.launches += 1
        return y, ld


class _CouplingInv(Kernel):
    def __call__(self, y, raw, t, clamp: float = 2.0):
        """y, raw, t: (B, M, ca) -> x: contiguous (B, M, ca) in y's dtype."""
        b, m, ca = _check(self.name, y, raw, t)
        x = torch.empty((b, m, ca), dtype=y.dtype, device=y.device)
        err = _fn("coupling_inv")(
            KERNEL_DTYPES[y.dtype], y.data_ptr(), y.stride(0), y.stride(1), raw.data_ptr(),
            t.data_ptr(), raw.stride(0), raw.stride(1), x.data_ptr(), b, m, ca, clamp,
            y.device.index, stream(y),
        )
        raise_on(err, self.name)
        self.launches += 1
        return x


class _CouplingBwd(Kernel):
    def __call__(self, y, raw, t, gy, gld, clamp: float = 2.0):
        """y, raw, t, gy: (B, M, ca); gld: (B,) -> (x, gx, graw, gt),
        contiguous (B, M, ca) in y's dtype."""
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
        raise_on(err, self.name)
        self.launches += 1
        return x, gx, graw, gt


coupling_fwd = _CouplingFwd("coupling_fwd")
coupling_inv = _CouplingInv("coupling_inv")
coupling_bwd = _CouplingBwd("coupling_bwd")
KERNELS = (coupling_fwd, coupling_inv, coupling_bwd)
