"""Plain PyTorch version of the fused affine-coupling backward: the CPU path
of ``kernels/flowstep/ops.py::fused_coupling_half_bwd``, the oracle the CUDA
kernel is held against on the card, and the port of the reference's
``kernels/coupling/ref.py::coupling_bwd_ref`` (held to <=1e-4 in f32).
"""

from __future__ import annotations

import torch


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
