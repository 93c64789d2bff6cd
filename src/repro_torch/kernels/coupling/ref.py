"""Plain PyTorch versions of the fused affine coupling: the CPU path of
``kernels/coupling/ops.py``, the oracles the CUDA kernels are held against on
the card, and the port of the reference's ``kernels/coupling/ref.py`` (held
to <=1e-4 in f32).

The math is in f32 whatever the storage type; ``log_s = clamp *
tanh(raw / clamp)``.
"""

from __future__ import annotations

import torch


def coupling_fwd_ref(x, raw, t, clamp: float = 2.0):
    """(y, ld): ``y = x*exp(log_s) + t`` on (B, M, ca), and ``ld`` (B,) the
    f32 sum of ``log_s`` over (m, c)."""
    log_s = clamp * torch.tanh(raw.float() / clamp)
    y = x.float() * torch.exp(log_s) + t.float()
    return y.to(x.dtype), torch.sum(log_s, dim=(1, 2))


def coupling_inv_ref(y, raw, t, clamp: float = 2.0):
    """``x = (y - t) * exp(-log_s)``, the exact inverse of the forward."""
    log_s = clamp * torch.tanh(raw.float() / clamp)
    return ((y.float() - t.float()) * torch.exp(-log_s)).to(y.dtype)


def coupling_bwd_ref(y, raw, t, gy, gld, clamp: float = 2.0):
    """(x, gx, graw, gt) from the output side of ``y = x*exp(log_s) + t``,
    ``log_s = clamp*tanh(raw/clamp)``: y, raw, t, gy (B, M, ca), gld (B,)."""
    th = torch.tanh(raw.float() / clamp)
    log_s = clamp * th
    e_s = torch.exp(log_s)
    gy32 = gy.float()
    x = (y.float() - t.float()) * torch.exp(-log_s)
    gx = gy32 * e_s
    graw = (gy32 * x * e_s + gld.float()[:, None, None]) * (1.0 - th * th)
    return x.to(y.dtype), gx.to(y.dtype), graw.to(raw.dtype), gy32.to(t.dtype)
