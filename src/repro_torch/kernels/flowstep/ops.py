"""Public wrappers of the fused flow step, dispatched by tensor device.

CPU tensors take the plain versions in ``ref.py``.  CUDA tensors take the
hand-written kernels in ``flowstep.py``, wrapped in an
``autograd.Function`` whose backward raises: the backward kernels
(``coupling_bwd``, ``spine_bwd``) come with the training slice, and until
then a gradient through the kernel fails loudly instead of coming back empty.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import use_plain
from repro_torch.kernels.flowstep import flowstep as _k
from repro_torch.kernels.flowstep.ref import flowstep_fwd_ref, flowstep_inv_ref

_NO_BACKWARD = "training kernels: ROADMAP queue 2"


class _FwdFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, an_log_s, an_b, w, raw, t, clamp):
        return _k.flowstep_fwd(x, an_log_s, an_b, w, raw, t, clamp)

    @staticmethod
    def backward(ctx, gy, gld):
        raise NotImplementedError(_NO_BACKWARD)


class _InvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, an_log_s, an_b, w_inv, raw, t, clamp):
        return _k.flowstep_inv(y, an_log_s, an_b, w_inv, raw, t, clamp)

    @staticmethod
    def backward(ctx, gx):
        raise NotImplementedError(_NO_BACKWARD)


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
