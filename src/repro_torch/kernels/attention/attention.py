"""Binding of the hand-written CUDA flash attention (``csrc/attention.cu``).

``flash_attention`` replaces the Pallas kernel of the same name in
``repro/kernels/attention/attention.py``.  It is bound by operations (two
D-long products per visible (query, key) pair); the source note in
``attention.cu`` gives the design.  The wrapper checks what the kernel takes,
allocates the output with q's strides (so a (B, S, H, D) tensor viewed as
(B, H, S, D) comes back in the same layout, and the caller's swap back costs
no copy), launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import KERNEL_DTYPES, Kernel, bind, raise_on, stream

#: the head dims the kernel takes: multiples of 4 (float4 tiles) up to 128
MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
              _I, ctypes.c_float, _I, _P]


class _FlashAttention(Kernel):
    def __call__(self, q, k, v, causal: bool = True):
        """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), f32 or bf16, any
        strides with D contiguous -> o: (B, Hq, Sq, D) in q's dtype."""
        if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"{self.name} takes float32 or bfloat16 q, k, v of one dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
            raise ValueError(f"{self.name}: q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        b, hq, sq, d = q.shape
        _, hkv, skv, dk = k.shape
        if k.shape[0] != b or dk != d or hq % hkv or 0 in q.shape or 0 in k.shape:
            raise ValueError(f"{self.name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} need "
                             "one batch, one head_dim and Hq % Hkv == 0")
        if d % 4 or d > MAX_HEAD_DIM:
            raise ValueError(f"{self.name}: head_dim {d} is not a multiple of 4 up to "
                             f"{MAX_HEAD_DIM}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError(f"{self.name}: the head_dim axis of q, k and v must be contiguous")
        if len({q.device, k.device, v.device}) != 1:
            raise ValueError(f"{self.name}: q, k and v must be on one device")
        o = torch.empty_like(q)
        if o.stride(-1) != 1:
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
        err = bind("attention", "flash_attention", _SIGNATURE)(
            KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hkv, sq, skv, d, strides, int(causal), d**-0.5, q.device.index, stream(q),
        )
        raise_on(err, self.name)
        self.launches += 1
        return o


flash_attention = _FlashAttention("flash_attention")
KERNELS = (flash_attention,)
