"""Public wrappers of the fused affine coupling, dispatched by tensor device.

Each goes to its CUDA kernel (``kernels/coupling/coupling.py``) when its
tensors lie on one CUDA device, and to the plain version (``ref.py``) when
they lie on the CPU; nothing falls back from the card to the plain version.

* ``fused_coupling_fwd_rows`` / ``fused_coupling_inv_rows`` are the
  coupling layer's whole op, from its (B, M, C) input (or output) row and
  its conditioner output h to the (B, M, C) output (or input) row: the
  row stream on the card (``coupling_fwd.rows``), the row versions in
  ``ref.py`` on the CPU, bit for bit the half's result joined to the
  pass-through half.  The forward is an ``autograd.Function``, as the
  reference's ``custom_vjp`` (``_fwd_fwd`` / ``_fwd_bwd``): it saves only
  the output side ``(y, h)``; its backward is :func:`fused_coupling_bwd_rows`
  (which rebuilds ``x`` in the same pass that emits the cotangents), whose
  row cotangent and ``(graw | gt)`` it returns as they come.  The inverse
  has no gradient, as the reference's ``coupling_inv`` has no VJP; its
  backward raises.
* ``fused_coupling_fwd`` / ``fused_coupling_inv`` keep the half contract,
  (B, M, ca) in and out: the same ops on h = ``(raw | t)``, whose width 2 ca
  makes all of x the transformed half.
* :func:`fused_coupling_bwd_rows` is the coupling backward on whole rows,
  ``(y, h, gy) -> (x, gx, gh)``: ``AffineCoupling.fused_bwd``, the scanned
  step's ``_step_bwd``, the forward's backward here and the flow step's
  backward (``kernels/flowstep/ops.py``) all call it, and none of them joins
  halves.  On the card it is ``coupling_bwd.rows`` (the backward's row
  stream at the GLOW widths; else the half kernel and the joins), on the CPU
  ``coupling_bwd_rows_ref``.
* :func:`fused_coupling_bwd` keeps the half contract, (B, M, ca) views of
  the transformed half: the row op on h = ``(raw | t)``, whose width 2 ca
  makes all of y the transformed half (so the half kernel on the card), with
  gh split back into graw and gt.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import use_plain
from repro_torch.kernels.coupling import coupling as _k
from repro_torch.kernels.coupling.ref import (coupling_bwd_rows_ref, coupling_fwd_rows_ref,
                                              coupling_inv_rows_ref)


def fused_coupling_bwd(y, raw, t, gy, gld, clamp: float = 2.0):
    """The coupling backward from the output side: ``(x, gx, graw, gt)``
    for y, raw, t, gy (B, M, ca) and gld (B,); graw/gt feed the
    conditioner's VJP."""
    ca = raw.shape[-1]
    x, gx, gh = fused_coupling_bwd_rows(y, torch.cat([raw, t], dim=-1), gy, gld, clamp=clamp)
    return x, gx, gh[..., :ca], gh[..., ca:]


def fused_coupling_bwd_rows(y, h, gy, gld, flip: bool = False, clamp: float = 2.0):
    """The coupling backward on whole rows, from the output side: y, gy (B,
    M, C), h (B, M, 2 n), gld (B,) -> ``(x, gx, gh)``: the layer's input
    row, the cotangent of x with gy's pass-through half (the caller adds the
    conditioner's cotangent into that half), and h's cotangent ``(graw |
    gt)``, for the conditioner's VJP."""
    if use_plain(y, h, gy, gld):
        return coupling_bwd_rows_ref(y, h, gy, gld, flip=flip, clamp=clamp)
    return _k.coupling_bwd.rows(y, h, gy, gld, flip, clamp)


class _FwdFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, flip, clamp):
        if use_plain(x, h):
            y, ld = coupling_fwd_rows_ref(x, h, flip=flip, clamp=clamp)
        else:
            y, ld = _k.coupling_fwd.rows(x, h, flip, clamp)
        ctx.save_for_backward(y, h)
        ctx.flip, ctx.clamp = flip, clamp
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        y, h = ctx.saved_tensors
        _x, gx, gh = fused_coupling_bwd_rows(y, h, gy.contiguous(), gld, ctx.flip, ctx.clamp)
        return gx, gh, None, None


class _InvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, h, flip, clamp):
        if use_plain(y, h):
            return coupling_inv_rows_ref(y, h, flip=flip, clamp=clamp)
        return _k.coupling_inv.rows(y, h, flip, clamp)

    @staticmethod
    def backward(ctx, gx):
        raise NotImplementedError(
            "coupling_inv has no gradient, as in the reference; "
            "differentiate the forward instead")


def fused_coupling_fwd_rows(x, h, flip: bool = False, clamp: float = 2.0):
    """The coupling layer's forward on whole rows: x (B, M, C) and its
    conditioner output h (B, M, 2 n), n the transformed width, ->
    ``(y (B, M, C), ld (B,) f32)``; differentiable, from the output side."""
    return _FwdFn.apply(x, h, flip, clamp)


def fused_coupling_inv_rows(y, h, flip: bool = False, clamp: float = 2.0):
    """The coupling layer's inverse on whole rows: y (B, M, C) and h ->
    x (B, M, C) (the sampling path)."""
    return _InvFn.apply(y, h, flip, clamp)


def fused_coupling_fwd(x, raw, t, clamp: float = 2.0):
    """``y = x*exp(log_s) + t`` and ``ld`` (B,) f32 on (B, M, ca):
    differentiable, from the output side."""
    return fused_coupling_fwd_rows(x, torch.cat([raw, t], dim=-1), clamp=clamp)


def fused_coupling_inv(y, raw, t, clamp: float = 2.0):
    """``x = (y - t)*exp(-log_s)`` on (B, M, ca) (the sampling path)."""
    return fused_coupling_inv_rows(y, torch.cat([raw, t], dim=-1), clamp=clamp)
