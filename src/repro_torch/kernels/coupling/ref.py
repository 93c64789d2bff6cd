"""Plain PyTorch versions of the fused affine coupling: the CPU path of
``kernels/coupling/ops.py``, the oracles the CUDA kernels are held against on
the card, and the port of the reference's ``kernels/coupling/ref.py`` (held
to <=1e-4 in f32).

The math is in f32 whatever the storage type; ``log_s = clamp *
tanh(raw / clamp)``.  The row versions compute the coupling layer's whole
(B, M, C) output from its whole input and conditioner output, as the row
stream does: the half's version joined to the pass-through half, bit for bit
the layer's ``_merge`` of the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import stream_ld
from repro_torch.kernels.coupling.coupling import (COUPLING_PLAN, coupling_rows_per_tile,
                                                   join_rows, row_halves)


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


def coupling_fwd_rows_ref(x, h, flip: bool = False, clamp: float = 2.0):
    """(y, ld): the layer's output row (B, M, C), its transformed half by
    :func:`coupling_fwd_ref` (raw, t the halves of ``h``) and its
    pass-through half as it was (none when h is 2 C wide)."""
    xa, xb, raw, t = row_halves(x, h, flip)
    ya, ld = coupling_fwd_ref(xa, raw, t, clamp=clamp)
    return join_rows(ya, xb, flip), ld


def coupling_inv_rows_ref(y, h, flip: bool = False, clamp: float = 2.0):
    """The layer's input row (B, M, C) from its output row: the transformed
    half by :func:`coupling_inv_ref`, the pass-through half as it was."""
    ya, yb, raw, t = row_halves(y, h, flip)
    return join_rows(coupling_inv_ref(ya, raw, t, clamp=clamp), yb, flip)


def coupling_bwd_rows_ref(y, h, gy, gld, flip: bool = False, clamp: float = 2.0):
    """The coupling backward on whole rows, from the output side: y, gy (B,
    M, C), h (B, M, 2 n), gld (B,) -> ``(x, gx, gh)``.  x is the layer's
    input row (the transformed half by :func:`coupling_bwd_ref`, the
    pass-through half as it was), gx the cotangent of x with gy's
    pass-through half (the caller adds the conditioner's cotangent into it),
    gh = ``(graw | gt)`` the cotangent of h: bit for bit the joins the
    callers made of the half's results."""
    ya, yb, raw, t = row_halves(y, h, flip)
    gya, gyb, _, _ = row_halves(gy, h, flip)
    xa, gxa, graw, gt = coupling_bwd_ref(ya, raw, t, gya, gld, clamp=clamp)
    return (join_rows(xa, yb, flip), join_rows(gxa, gyb.to(gxa.dtype), flip),
            torch.cat([graw, gt], dim=-1))


def coupling_stream_ref(x, h, clamp: float = 2.0, inverse: bool = False):
    """The row stream's arithmetic in plain PyTorch (``csrc/coupling.cu``,
    ``coupling_rows_kernel``; C in ``STREAM_WIDTHS``, the first half
    coupled).  Forward: ``(y, ld)``, y as :func:`coupling_fwd_rows_ref`
    computes it, ld summed in the kernel's order (``stream_ld``: a tile is
    ``coupling_rows_per_tile(C)`` rows of one batch; lane l adds the log_s
    of rows (l // G) RPL + u and then columns (l % G) K + j, G = C / 2 / K;
    the tile's 32 lanes by the kernel's shuffle tree; the tiles of a batch
    as ``ld_reduce_kernel`` adds them).  With ``inverse`` (x = y): the
    input row as :func:`coupling_inv_rows_ref` computes it."""
    if inverse:
        return coupling_inv_rows_ref(x, h, clamp=clamp)
    y, _ = coupling_fwd_rows_ref(x, h, clamp=clamp)
    c = x.shape[-1]
    k, rpl, _ = COUPLING_PLAN
    log_s = clamp * torch.tanh(h[..., : c // 2].float() / clamp)
    return y, stream_ld(log_s, coupling_rows_per_tile(c), rpl, k, c // 2 // k)
