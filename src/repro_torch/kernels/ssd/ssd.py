"""Binding of the hand-written CUDA Mamba2 SSD scan (``csrc/ssd.cu``).

``ssd_scan`` replaces the Pallas kernel of the same name in
``repro/kernels/ssd/ssd.py``, keeping its contract (the chunk is
``min(chunk, S)`` and must divide S; y in x's dtype, the state in f32) with
one more input: an optional initial state (absent means zeros, the TPU
kernel's case), which the model's chunk scan needs.  It is bound by
operations (four f32 products per (batch, head, chunk)); the source note in
``ssd.cu`` gives the design.  The wrapper checks what the kernel takes,
allocates y with x's strides (so a (B, S, H, P) tensor viewed as
(B, H, S, P) comes back in the same layout) and the final state, launches on
PyTorch's current stream, raises if the launch was refused, and adds one to
its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: the largest head dim P and state size N (one 64-wide tile each)
MAX_WIDTH = 64
#: the longest chunk (its cumulative decays stay in shared memory)
MAX_CHUNK = 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              ctypes.POINTER(ctypes.c_longlong), _I, _P]


def check_chunk(s: int, chunk: int) -> int:
    """The chunk the scan takes, ``min(chunk, s)``; raises unless it divides
    ``s``, where the reference's kernel asserts."""
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"sequence {s} is not divisible by chunk {c}")
    return c


class _SsdScan(Kernel):
    def __call__(self, x, da, dt, b_in, c_in, chunk: int = 128, state0=None):
        """x: (B, H, S, P); da, dt: (B, H, S) f32; b_in, c_in: (B, S, N) in
        x's dtype (f32 or bf16), last axes contiguous; state0: (B, H, P, N) or
        None (zeros) -> (y (B, H, S, P) in x's dtype, state (B, H, P, N) f32)."""
        if x.dtype not in KERNEL_DTYPES or b_in.dtype != x.dtype or c_in.dtype != x.dtype:
            raise TypeError(f"{self.name} takes float32 or bfloat16 x, b_in, c_in of one dtype, "
                            f"got {x.dtype}, {b_in.dtype}, {c_in.dtype}")
        if da.dtype != torch.float32 or dt.dtype != torch.float32:
            raise TypeError(f"{self.name} takes float32 da and dt, got {da.dtype}, {dt.dtype}")
        if x.ndim != 4 or 0 in x.shape:
            raise ValueError(f"{self.name}: x must be a non-empty (B, H, S, P), got "
                             f"{tuple(x.shape)}")
        b, h, s, p = x.shape
        n = b_in.shape[-1]
        if (da.shape != (b, h, s) or dt.shape != (b, h, s) or b_in.shape != (b, s, n)
                or c_in.shape != (b, s, n)):
            shapes = [tuple(t.shape) for t in (da, dt, b_in, c_in)]
            raise ValueError(f"{self.name}: da, dt (B, H, S) and b_in, c_in (B, S, N) do not "
                             f"fit x {tuple(x.shape)}: {shapes}")
        if not (1 <= p <= MAX_WIDTH and 1 <= n <= MAX_WIDTH):
            raise ValueError(f"{self.name}: head dim {p} and state size {n} must be 1..{MAX_WIDTH}")
        c = check_chunk(s, chunk)
        if c > MAX_CHUNK:
            raise ValueError(f"{self.name}: chunk {c} is longer than {MAX_CHUNK}")
        if state0 is not None and tuple(state0.shape) != (b, h, p, n):
            raise ValueError(f"{self.name}: state0 must be {(b, h, p, n)}, got "
                             f"{tuple(state0.shape)}")
        if any(t.stride(-1) != 1 for t in (x, b_in, c_in)):
            raise ValueError(f"{self.name}: the last axis of x, b_in and c_in must be contiguous")
        tensors = (x, da, dt, b_in, c_in) + (() if state0 is None else (state0,))
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{self.name}: every input must be on one device")
        if state0 is not None:
            state0 = state0.float().contiguous()
        y = torch.empty_like(x)
        if y.stride(-1) != 1:
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        strides = (ctypes.c_longlong * 16)(
            *x.stride()[:3], *da.stride(), *dt.stride(), *b_in.stride()[:2], *c_in.stride()[:2],
            *y.stride()[:3])
        err = bind("ssd", "ssd_scan", _SIGNATURE)(
            KERNEL_DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), dt.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), b, h, s, p, n, c, strides, x.device.index, stream(x),
        )
        raise_on(err, self.name)
        self.launches += 1
        return y, state


ssd_scan = _SsdScan("ssd_scan")
KERNELS = (ssd_scan,)
