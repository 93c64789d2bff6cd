"""Bindings of the hand-written CUDA flow-step kernels (``csrc/flowstep.cu``).

``flowstep_fwd``, ``flowstep_inv`` and ``spine_bwd`` replace the Pallas
kernels of the same names in ``repro/kernels/flowstep/flowstep.py``.  All
three are memory-bound at the served widths (12*B*M*C bytes a launch in f32
for the first two, 16*B*M*C for ``spine_bwd``); the source notes in
``flowstep.cu`` give the design.  Each wrapper checks what the kernel takes,
allocates the outputs, launches on PyTorch's current stream, raises if the
launch was refused, and adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES as _DTYPES
from repro_torch.kernels.common import Kernel, bind, raise_on

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
    "spine_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _P],
}


def _fn(name: str):
    return bind("flowstep", name, _SIGNATURES[name])


def smem_bytes(c: int, block_m: int) -> int:
    """Shared memory one block takes: W (C*C), exp(an_log_s) and an_b (2*C),
    the tile (block_m*C) and 8 warp sums, in f32 (``smem_bytes`` in
    ``flowstep.cu``)."""
    return 4 * (c * c + 2 * c + block_m * c + 8)


def spine_smem_bytes(c: int, block_m: int) -> int:
    """Shared memory one ``spine_bwd`` block takes: W and W^-1 (2*C*C), the
    channel vectors (3*C) and three tiles (3*block_m*C), in f32
    (``spine_smem_bytes`` in ``flowstep.cu``)."""
    return 4 * (2 * c * c + 3 * c + 3 * block_m * c)


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


class _FlowstepFwd(Kernel):
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
        raise_on(err, self.name)
        self.launches += 1
        return y, ld


class _FlowstepInv(Kernel):
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
        raise_on(err, self.name)
        self.launches += 1
        return x


class _SpineBwd(Kernel):
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
        block_m = max(1, min(m, TILE_ELEMS // c))
        if spine_smem_bytes(c, block_m) > SMEM_LIMIT:
            raise ValueError(f"C={c}: W, W^-1 and the tiles do not fit in {SMEM_LIMIT} bytes "
                             "of shared memory")
        w32, wi32, ls, ab = (v.to(torch.float32).contiguous() for v in (w, w_inv, an_log_s, an_b))
        n_blocks = b * -(-m // block_m)
        x = torch.empty_like(x2)
        gx = torch.empty_like(x2)
        partial = torch.empty((n_blocks, c * c + 2 * c), dtype=torch.float32, device=x2.device)
        sums = torch.empty((c * c + 2 * c,), dtype=torch.float32, device=x2.device)
        err = _fn("spine_bwd")(
            _DTYPES[x2.dtype], x2.data_ptr(), gx2.data_ptr(), w32.data_ptr(), wi32.data_ptr(),
            ls.data_ptr(), ab.data_ptr(), x.data_ptr(), gx.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), b, m, c, block_m, x2.device.index,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
        raise_on(err, self.name)
        self.launches += 1
        return x, gx, sums[: c * c].view(c, c), sums[c * c: c * c + c], sums[c * c + c:]


flowstep_fwd = _FlowstepFwd("flowstep_fwd")
flowstep_inv = _FlowstepInv("flowstep_inv")
spine_bwd = _SpineBwd("spine_bwd")
KERNELS = (flowstep_fwd, flowstep_inv, spine_bwd)
