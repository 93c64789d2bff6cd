"""2-D convolution primitives (NHWC activations, HWIO weights), used by the
coupling conditioners.

Weights keep the reference's HWIO layout in the parameter tree, so carrying
them across is a plain copy; ``conv2d_apply`` permutes to PyTorch's NCHW/OIHW
views and back.  The NCHW view of an NHWC tensor is channels-last in memory,
which cuDNN takes as it is.  These convolutions stay with cuDNN, as they stay
with XLA in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_init(generator: torch.Generator, c_in: int, c_out: int, k: int = 3, *,
                scale: str | float = "he", dtype=torch.float32) -> dict:
    """``{"w": (k, k, c_in, c_out), "b": (c_out,)}`` on the CPU, drawn from
    ``generator``; the caller moves them to their device."""
    if scale == "zeros":
        w = torch.zeros((k, k, c_in, c_out), dtype=dtype)
    else:
        fan_in = k * k * c_in
        std = (2.0 / fan_in) ** 0.5 if scale == "he" else float(scale)
        w = std * torch.randn((k, k, c_in, c_out), dtype=dtype, generator=generator)
    return {"w": w, "b": torch.zeros((c_out,), dtype=dtype)}


def conv2d_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 "SAME" convolution of an NHWC ``x`` by HWIO ``params["w"]``
    (odd kernel sizes: padding ``k // 2``)."""
    w = params["w"].to(x.dtype)
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=k // 2)
    return y.permute(0, 2, 3, 1) + params["b"].to(x.dtype)
