"""Activation normalization (GLOW) — invertible per-channel affine."""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.types import Invertible, resolve_device


def _spatial(x) -> int:
    return math.prod(x.shape[1:-1]) if x.ndim > 2 else 1


class ActNorm(Invertible):
    """y = x * exp(log_s) + b, per trailing-dim channel.

    ``logdet = spatial_size * sum(log_s)``.  Takes (B, D) and (B, H, W, C)
    inputs.  ``ddi`` gives GLOW's data-dependent initialisation.
    """

    def __init__(self, c: int, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.log_s = nn.Parameter(torch.zeros(c, device=dev))
        self.b = nn.Parameter(torch.zeros(c, device=dev))

    def forward(self, x, cond=None):
        y = x * torch.exp(self.log_s.to(x.dtype)) + self.b.to(x.dtype)
        ld = _spatial(x) * torch.sum(self.log_s).float()
        return y, ld.expand(x.shape[0])

    def inverse(self, y, cond=None):
        return (y - self.b.to(y.dtype)) * torch.exp(-self.log_s.to(y.dtype))

    def fused_bwd(self, y, gy, gld, cond=None):
        """The ``grad_mode="coupled"`` hook: ``(x, gx, {name: grad}, None)``
        from the output side.  ``x`` is rebuilt by the inverse affine and the
        cotangents are closed-form, summed in f32; the logdet's cotangent
        lands on ``log_s`` scaled by the spatial size (every channel adds
        ``spatial * log_s`` to each sample's logdet)."""
        log_s = self.log_s.detach()
        e_s = torch.exp(log_s.to(y.dtype))
        x = (y - self.b.detach().to(y.dtype)) * torch.exp(-log_s.to(y.dtype))
        gy = gy.to(y.dtype)
        axes = tuple(range(y.ndim - 1))
        gy32 = gy.float()
        g_log_s = (torch.sum(gy32 * x.float() * e_s.float(), dim=axes)
                   + _spatial(y) * torch.sum(gld.float()))
        grads = {"log_s": g_log_s.to(self.log_s.dtype),
                 "b": torch.sum(gy32, dim=axes).to(self.b.dtype)}
        return x, gy * e_s, grads, None

    @staticmethod
    def ddi(x: torch.Tensor, eps: float = 1e-6) -> dict:
        """Data-dependent init: post-layer activations have zero mean and
        unit variance.  Returns ``{"log_s", "b"}`` (load with
        ``load_state_dict``)."""
        axes = tuple(range(x.ndim - 1))
        mu = torch.mean(x, dim=axes)
        # population std (ddof 0), as jnp.std
        sd = torch.std(x, dim=axes, correction=0) + eps
        return {"log_s": (-torch.log(sd)).float(), "b": (-mu / sd).float()}
