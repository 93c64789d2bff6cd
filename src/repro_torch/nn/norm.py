"""Normalisation primitives, the port of the reference's ``nn/norm.py``.

The rounding order is the reference's: normalise in f32, cast to x's dtype,
then multiply by gamma cast to x's dtype."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the trailing dimension, computed in f32."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)
