"""Haar wavelet multiscale transform and plain squeeze.

The orthonormal 2x2 Haar transform maps (B, H, W, C) -> (B, H/2, W/2, 4C)
with |det| = 1 (logdet = 0).  Used as the invertible down-sampling of
GLOW-style multiscale flows.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import Invertible, zero_logdet


def _blocks(x):
    return x[:, 0::2, 0::2, :], x[:, 0::2, 1::2, :], x[:, 1::2, 0::2, :], x[:, 1::2, 1::2, :]


def _unblocks(a, b, c, d):
    """Inverse of ``_blocks``: interleave four (B, H/2, W/2, C) tensors into
    (B, H, W, C) by strided assignment."""
    bsz, h2, w2, ch = a.shape
    x = torch.empty((bsz, 2 * h2, 2 * w2, ch), dtype=a.dtype, device=a.device)
    x[:, 0::2, 0::2, :] = a
    x[:, 0::2, 1::2, :] = b
    x[:, 1::2, 0::2, :] = c
    x[:, 1::2, 1::2, :] = d
    return x


def _check_even(name, x):
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name} needs even H, W; got {tuple(x.shape)}")


class _OrthonormalSqueeze(Invertible):
    """The ``grad_mode="coupled"`` hook both squeezes share.  Each is a
    linear map ``y = A x`` with ``A`` orthogonal (Haar: the orthonormal 2x2
    wavelet basis; plain squeeze: a permutation), so the transpose the VJP
    needs is the inverse: ``x = inverse(y)``, ``gx = inverse(gy)``."""

    def fused_bwd(self, y, gy, gld, cond=None):
        return self.inverse(y), self.inverse(gy.to(y.dtype)), {}, None


class HaarSqueeze(_OrthonormalSqueeze):
    """Orthonormal Haar squeeze; an involution on the block basis."""

    def forward(self, x, cond=None):
        _check_even("HaarSqueeze", x)
        a, b, c, d = _blocks(x)
        ll = (a + b + c + d) * 0.5
        lh = (a - b + c - d) * 0.5
        hl = (a + b - c - d) * 0.5
        hh = (a - b - c + d) * 0.5
        return torch.cat([ll, lh, hl, hh], dim=-1), zero_logdet(x)

    def inverse(self, y, cond=None):
        ll, lh, hl, hh = torch.chunk(y, 4, dim=-1)
        return _unblocks(
            (ll + lh + hl + hh) * 0.5,
            (ll - lh + hl - hh) * 0.5,
            (ll + lh - hl - hh) * 0.5,
            (ll - lh - hl + hh) * 0.5,
        )


class Squeeze(_OrthonormalSqueeze):
    """Plain space-to-depth squeeze (RealNVP); logdet = 0."""

    def forward(self, x, cond=None):
        _check_even("Squeeze", x)
        return torch.cat(_blocks(x), dim=-1), zero_logdet(x)

    def inverse(self, y, cond=None):
        return _unblocks(*torch.chunk(y, 4, dim=-1))
