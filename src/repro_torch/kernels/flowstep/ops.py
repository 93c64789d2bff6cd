"""Public wrappers of the fused flow step, dispatched by tensor device.

CPU tensors take the plain versions in ``ref.py`` (and the coupling half's
in ``kernels/coupling/ops.py``), which autograd differentiates directly.  CUDA
tensors take the hand-written kernels.  ``fused_flowstep_fwd`` is then an
``autograd.Function`` whose backward is :func:`flowstep_fwd_vjp`: the two
backward kernels (``coupling_bwd`` on whole rows, ``spine_bwd``) from the
output side, as the reference's ``_fwd_pallas_bwd``.  It saves the output,
raw/t and the step's parameters, never the intermediates.
``fused_flowstep_inv`` has no gradient on the card, as the reference's
``flowstep_inv`` has no VJP.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import use_plain
from repro_torch.kernels.coupling.ops import fused_coupling_bwd_rows
from repro_torch.kernels.flowstep import flowstep as _k
from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref, spine_bwd_ref


def conditioner_output(raw, t):
    """The one (B, M, 2 ca) tensor h whose halves ``raw`` and ``t`` are (a
    view of it, as the step passes them), or, for two separate tensors,
    their join."""
    b, m, ca = raw.shape
    if (raw.dtype == t.dtype and raw.stride() == t.stride() == (m * 2 * ca, 2 * ca, 1)
            and t.data_ptr() == raw.data_ptr() + ca * raw.element_size()):
        return raw.as_strided((b, m, 2 * ca), raw.stride())
    return torch.cat([raw, t], dim=-1)


def flowstep_fwd_vjp(y, raw, t, an_log_s, an_b, w, gy, gld, clamp: float = 2.0):
    """Cotangents of ``fused_flowstep_fwd``'s inputs from its output side:
    ``coupling_bwd`` on whole rows (the conv output x2, its cotangent gx2,
    and h's (graw | gt)), then ``W^-1``, then ``spine_bwd``.  Returns
    ``(gx, g_an_log_s, g_an_b, gW, graw, gt)``."""
    ca = raw.shape[-1]
    x2, gx2, gh = fused_coupling_bwd_rows(y, conditioner_output(raw, t), gy, gld, clamp=clamp)
    w_inv = torch.linalg.inv(w.float())
    _x, gx, gw, g_ls, g_b = fused_spine_bwd(x2, gx2, w, w_inv, an_log_s, an_b)
    return (gx, g_ls.to(an_log_s.dtype), g_b.to(an_b.dtype), gw.to(w.dtype), gh[..., :ca],
            gh[..., ca:])


class _FwdFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, an_log_s, an_b, w, raw, t, clamp):
        y, ld = _k.flowstep_fwd(x, an_log_s, an_b, w, raw, t, clamp)
        ctx.save_for_backward(y, raw, t, an_log_s, an_b, w)
        ctx.clamp = clamp
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        y, raw, t, an_log_s, an_b, w = ctx.saved_tensors
        return (*flowstep_fwd_vjp(y, raw, t, an_log_s, an_b, w, gy.contiguous(), gld,
                                  ctx.clamp), None)


class _InvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, an_log_s, an_b, w_inv, raw, t, clamp):
        return _k.flowstep_inv(y, an_log_s, an_b, w_inv, raw, t, clamp)

    @staticmethod
    def backward(ctx, gx):
        raise NotImplementedError(
            "flowstep_inv has no gradient, as in the reference; "
            "differentiate the forward instead")


def fused_flowstep_fwd(x, an_log_s, an_b, w, raw, t, clamp: float = 2.0):
    """One flow step (actnorm -> conv1x1 -> coupling) given the conditioner's
    raw/t: (B, M, C) -> (y, ld_coupling)."""
    if use_plain(x, an_log_s, an_b, w, raw, t):
        return flowstep_fwd_ref(x, an_log_s, an_b, w, raw, t, clamp=clamp)
    return _FwdFn.apply(x, an_log_s, an_b, w, raw, t, clamp)


def fused_flowstep_inv(y, an_log_s, an_b, w_inv, raw, t, clamp: float = 2.0):
    """Inverse flow step given ``W^-1`` (the sampling path)."""
    if use_plain(y, an_log_s, an_b, w_inv, raw, t):
        return flowstep_inv_ref(y, an_log_s, an_b, w_inv, raw, t, clamp=clamp)
    return _InvFn.apply(y, an_log_s, an_b, w_inv, raw, t, clamp)


def fused_spine_bwd(x2, gx2, w, w_inv, an_log_s, an_b):
    """The flow-step backward after the coupling half, conv1x1 + actnorm from
    the conv output side: ``(x, gx, gW, g_log_s, g_b)``."""
    if use_plain(x2, gx2, w, w_inv, an_log_s, an_b):
        return spine_bwd_ref(x2, gx2, w, w_inv, an_log_s, an_b)
    return _k.spine_bwd(x2.contiguous(), gx2.contiguous(), w, w_inv, an_log_s, an_b)
