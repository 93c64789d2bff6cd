"""Conditioner networks for coupling layers.

The conditioner is an arbitrary, non-invertible network: it maps the
untransformed half of a coupling to the scale/shift of the transformed half.
Its last layer is zero-initialised (the GLOW convention), so every coupling
starts as the identity.  ``CouplingMLP`` serves dense (B, D) flows (cHINT),
``CouplingCNN`` image (B, H, W, C) flows (GLOW).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import ParamTree, resolve_device
from repro_torch.nn.conv import conv2d_apply, conv2d_init
from repro_torch.nn.linear import dense_apply, dense_init


def coupling_mlp_init(generator: torch.Generator, d_in: int, d_out: int, hidden: int = 128,
                      depth: int = 2, d_cond: int = 0) -> dict:
    """Parameters of the MLP conditioner, on the CPU: ``depth`` hidden
    layers (He init) and a zero-initialised output layer, under
    ``{"layers": [{"w", "b"}, ...]}`` as in the reference."""
    dims = [d_in + d_cond] + [hidden] * depth
    layers = [dense_init(generator, dims[i], dims[i + 1], scale="he") for i in range(depth)]
    layers.append(dense_init(generator, dims[-1], d_out, scale="zeros"))
    return {"layers": layers}


class CouplingMLP(nn.Module):
    """MLP conditioner for dense (B, D) flows: d_in (+ d_cond) -> d_out.
    The port takes the widths at construction, where the reference reads
    them at ``init``; parameters are ``layers.{i}.w`` / ``layers.{i}.b``."""

    def __init__(self, d_in: int, d_out: int, hidden: int = 128, depth: int = 2,
                 d_cond: int = 0, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        init = coupling_mlp_init(gen, d_in, d_out, hidden, depth, d_cond)
        self.layers = nn.ModuleList(ParamTree(p) for p in init["layers"])
        self.to(dev)

    def forward(self, x, cond=None):
        """(B, d_in) (+ cond (B, d_cond)) -> (B, d_out): dense layers with the
        tanh-approximated GELU between them (``jax.nn.gelu``'s default)."""
        h = x if cond is None else torch.cat([x, cond.to(x.dtype)], dim=-1)
        for i, p in enumerate(self.layers):
            h = dense_apply(p, h)
            if i < len(self.layers) - 1:
                h = F.gelu(h, approximate="tanh")
        return h


def coupling_cnn_init(generator: torch.Generator, c_in: int, c_out: int,
                      hidden: int = 64, c_cond: int = 0) -> dict:
    """Parameters of the 3x3-1x1-3x3 conditioner, on the CPU."""
    return {
        "conv1": conv2d_init(generator, c_in + c_cond, hidden, 3, scale="he"),
        "conv2": conv2d_init(generator, hidden, hidden, 1, scale="he"),
        "conv3": conv2d_init(generator, hidden, c_out, 3, scale="zeros"),
    }


def coupling_cnn_apply(params, x: torch.Tensor, cond=None) -> torch.Tensor:
    """(B, H, W, c_in) -> (B, H, W, c_out); ``params`` is anything indexed
    like the parameter dict (a ``CouplingCNN`` or one step's slice)."""
    h = x
    if cond is not None:
        if cond.ndim == 2:  # broadcast a vector condition over space
            cond = cond[:, None, None, :].expand(*x.shape[:3], cond.shape[-1])
        h = torch.cat([h, cond.to(x.dtype)], dim=-1)
    h = torch.relu(conv2d_apply(params["conv1"], h))
    h = torch.relu(conv2d_apply(params["conv2"], h))
    return conv2d_apply(params["conv3"], h)


class CouplingCNN(ParamTree):
    """3x3-1x1-3x3 convnet conditioner for image (B, H, W, C) flows (GLOW)."""

    def __init__(self, c_in: int, c_out: int, hidden: int = 64, c_cond: int = 0, *,
                 generator: torch.Generator | None = None, device=None):
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        super().__init__(coupling_cnn_init(gen, c_in, c_out, hidden, c_cond))
        self.to(dev)

    def forward(self, x, cond=None):
        return coupling_cnn_apply(self, x, cond)
