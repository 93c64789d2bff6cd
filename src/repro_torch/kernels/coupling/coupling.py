"""Binding of the hand-written CUDA coupling backward (``csrc/coupling.cu``).

``coupling_bwd`` replaces the Pallas kernel
``repro/kernels/coupling/coupling.py::coupling_bwd``.  It is memory-bound
(32 bytes an element in f32); the source note in ``coupling.cu`` gives the
design.  The wrapper checks what the kernel takes, allocates the outputs,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = [_I, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P,
              _I, _I, _I, _F, _I, _P]


class _CouplingBwd(Kernel):
    def __call__(self, y, raw, t, gy, gld, clamp: float = 2.0):
        """y, raw, t, gy: (B, M, ca) with unit channel stride (any row and
        batch strides; raw and t share theirs); gld: (B,) -> (x, gx, graw,
        gt), contiguous (B, M, ca) in y's dtype."""
        if y.dtype not in KERNEL_DTYPES:
            raise TypeError(f"coupling_bwd takes float32 or bfloat16, got {y.dtype}")
        if y.ndim != 3:
            raise ValueError(f"y must be (B, M, ca), got {tuple(y.shape)}")
        for name, v in (("y", y), ("raw", raw), ("t", t), ("gy", gy)):
            if v.dtype != y.dtype or v.shape != y.shape or v.stride(-1) != 1:
                raise ValueError(f"{name} must be {tuple(y.shape)} {y.dtype} with unit channel stride")
        if raw.stride() != t.stride():
            raise ValueError("raw and t must share strides")
        b, m, ca = y.shape
        if tuple(gld.shape) != (b,):
            raise ValueError(f"gld must be ({b},), got {tuple(gld.shape)}")
        gld32 = gld.to(torch.float32).contiguous()
        x, gx, graw, gt = (torch.empty((b, m, ca), dtype=y.dtype, device=y.device)
                           for _ in range(4))
        err = bind("coupling", "coupling_bwd", _SIGNATURE)(
            KERNEL_DTYPES[y.dtype], y.data_ptr(), y.stride(0), y.stride(1), raw.data_ptr(),
            t.data_ptr(), raw.stride(0), raw.stride(1), gy.data_ptr(), gy.stride(0),
            gy.stride(1), gld32.data_ptr(), x.data_ptr(), gx.data_ptr(), graw.data_ptr(),
            gt.data_ptr(), b, m, ca, clamp, y.device.index,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
        raise_on(err, self.name)
        self.launches += 1
        return x, gx, graw, gt


coupling_bwd = _CouplingBwd("coupling_bwd")
KERNELS = (coupling_bwd,)
