"""Plain PyTorch versions of the invertible 1x1 convolution's channel
product and weight cotangent: the CPU path of ``kernels/conv1x1/ops.py``,
the oracles the CUDA kernels are held against on the card, and the port of
the reference's ``kernels/conv1x1/ref.py::conv1x1_mm_ref`` and
``ops.py::_gw_ref``.

The numerics contract is the reference's: the operands are in the
activation dtype (W is rounded to x's dtype first), the products are summed
in f32, and gW is an f32 sum.
"""

from __future__ import annotations

import torch


def conv1x1_mm_ref(x, w):
    """``y[..., :] = x[..., :] @ W`` for x (..., C), W (C, C); y in x's dtype."""
    return (x.float() @ w.to(x.dtype).float()).to(x.dtype)


def conv1x1_gw_ref(x, gy):
    """``gW = sum over (b, m) of x[b, m, :]^T gy[b, m, :]``: (C, C) f32."""
    c = x.shape[-1]
    return x.reshape(-1, c).float().T @ gy.reshape(-1, c).float()
