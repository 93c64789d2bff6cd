"""Bindings of the hand-written CUDA flow-step kernels (``csrc/flowstep.cu``).

``flowstep_fwd`` replaces the Pallas kernel
``repro/kernels/flowstep/flowstep.py::flowstep_fwd`` and ``flowstep_inv``
replaces ``repro/kernels/flowstep/flowstep.py::flowstep_inv``.  Both are
memory-bound (12*B*M*C bytes a launch in f32); the source note in
``flowstep.cu`` gives the design.  Each wrapper checks what the kernel takes,
allocates the outputs, launches on PyTorch's current stream, raises if the
launch was refused, and adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may take without opting in to more
SMEM_LIMIT = 48 * 1024
#: elements a block stages: block_m = max(1, TILE_ELEMS // C) rows
TILE_ELEMS = 2048

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flowstep_fwd": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _P,
                     _I, _I, _I, _I, _I, _F, _I, _P],
    "flowstep_inv": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P,
                     _I, _I, _I, _I, _I, _F, _I, _P],
}


def _fn(name: str):
    f = getattr(library("flowstep"), name)
    if f.argtypes is None:
        f.argtypes = _SIGNATURES[name]
        f.restype = ctypes.c_int
    return f


def smem_bytes(c: int, block_m: int) -> int:
    """Shared memory one block takes: W (C*C), exp(an_log_s) and an_b (2*C),
    the tile (block_m*C) and 8 warp sums, in f32 (``smem_bytes`` in
    ``flowstep.cu``)."""
    return 4 * (c * c + 2 * c + block_m * c + 8)


def _check(x, an_log_s, an_b, w, raw, t):
    """Validate the kernel's inputs; returns (B, M, C, ca, block_m) and the
    f32 channel parameters."""
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
    params = [v.to(torch.float32).contiguous() for v in (an_log_s, an_b, w)]
    return (b, m, c, ca, block_m), params


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class _Kernel:
    """A CUDA entry point with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"<kernel {self.name}: {self.launches} launches>"


class _FlowstepFwd(_Kernel):
    def __call__(self, x, an_log_s, an_b, w, raw, t, clamp: float = 2.0):
        """x: (B, M, C); an_*: (C,); w: (C, C); raw, t: (B, M, ca)
        -> (y: (B, M, C) in x's dtype, ld_coupling: (B,) f32)."""
        (b, m, c, ca, block_m), (ls, ab, w32) = _check(x, an_log_s, an_b, w, raw, t)
        n_tiles = -(-m // block_m)
        y = torch.empty_like(x)
        partial = torch.empty((b, n_tiles), dtype=torch.float32, device=x.device)
        ld = torch.empty((b,), dtype=torch.float32, device=x.device)
        err = _fn("flowstep_fwd")(
            _DTYPES[x.dtype], x.data_ptr(), ls.data_ptr(), ab.data_ptr(),
            w32.data_ptr(), raw.data_ptr(), t.data_ptr(), raw.stride(0),
            raw.stride(1), y.data_ptr(), partial.data_ptr(), ld.data_ptr(),
            b, m, c, ca, block_m, clamp, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _raise_on(err, self.name)
        self.launches += 1
        return y, ld


class _FlowstepInv(_Kernel):
    def __call__(self, y, an_log_s, an_b, w_inv, raw, t, clamp: float = 2.0):
        """Inverse flow step given ``W^-1``: (B, M, C) -> (B, M, C)."""
        (b, m, c, ca, block_m), (ls, ab, wi32) = _check(y, an_log_s, an_b, w_inv, raw, t)
        x = torch.empty_like(y)
        err = _fn("flowstep_inv")(
            _DTYPES[y.dtype], y.data_ptr(), ls.data_ptr(), ab.data_ptr(),
            wi32.data_ptr(), raw.data_ptr(), t.data_ptr(), raw.stride(0),
            raw.stride(1), x.data_ptr(), b, m, c, ca, block_m, clamp, y.device.index,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
        _raise_on(err, self.name)
        self.launches += 1
        return x


flowstep_fwd = _FlowstepFwd("flowstep_fwd")
flowstep_inv = _FlowstepInv("flowstep_inv")
KERNELS = (flowstep_fwd, flowstep_inv)
