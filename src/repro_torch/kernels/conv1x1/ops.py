"""``invertible_conv1x1``: the 1x1-convolution op with its gradient, the
port of the reference's ``kernels/conv1x1/ops.py::invertible_conv1x1``.

An ``autograd.Function`` on either device, as the reference keeps the same
``custom_vjp`` structure on its kernel and reference paths:

* forward ``y = conv1x1_mm(x, W)``;
* backward ``gx = conv1x1_mm(gy, W^T)`` (W^T read through its strides, no
  copy) and ``gW = conv1x1_gw(x, gy)``, cast to W's dtype.

Each product goes to its CUDA kernel when its tensors lie on one CUDA
device and to the plain version in ``ref.py`` when they lie on the CPU.  As
in the reference, the ``Conv1x1`` layer (``core/conv1x1.py``) does not call
this op.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import use_plain
from repro_torch.kernels.conv1x1 import conv1x1 as _k
from repro_torch.kernels.conv1x1.ref import conv1x1_gw_ref, conv1x1_mm_ref


def _mm(x, w):
    if use_plain(x, w):
        return conv1x1_mm_ref(x, w)
    return _k.conv1x1_mm(x.contiguous(), w)


def _gw(x, gy):
    if use_plain(x, gy):
        return conv1x1_gw_ref(x, gy)
    return _k.conv1x1_gw(x.contiguous(), gy.contiguous())


class _Conv1x1Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        return _mm(gy, w.T), _gw(x, gy).to(w.dtype)


def invertible_conv1x1(x, w):
    """x: (B, M, C); w: (C, C) -> (B, M, C), differentiable in both."""
    if x.ndim != 3 or tuple(w.shape) != (x.shape[-1],) * 2:
        raise ValueError(f"invertible_conv1x1 takes x (B, M, C) and W (C, C), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    return _Conv1x1Fn.apply(x, w)
