"""Rotary position embeddings (RoPE), the port of the reference's
``nn/rotary.py``: the split-halves convention, angles in f32, the result
cast back to x's dtype."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, Dh) by position-dependent angles.

    ``positions`` has shape (..., S), broadcastable against x's batch and
    sequence axes.  Dims [0:D/2] and [D/2:D] form the rotated pairs."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions.float()[..., None] * inv  # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
