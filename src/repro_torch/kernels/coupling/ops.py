"""Public wrappers of the fused affine coupling, dispatched by tensor device.

Each goes to its CUDA kernel (``kernels/coupling/coupling.py``) when its
tensors lie on one CUDA device, and to the plain version (``ref.py``) when
they lie on the CPU; nothing falls back from the card to the plain version.

* ``fused_coupling_fwd`` is an ``autograd.Function`` on either device, as the
  reference's ``custom_vjp`` (``_fwd_fwd`` / ``_fwd_bwd``): it saves only the
  output side ``(y, raw, t)``, and its backward is :func:`fused_coupling_bwd`,
  which rebuilds ``x`` in the same pass that emits the cotangents.
* ``fused_coupling_inv`` has no gradient, as the reference's
  ``coupling_inv`` has no VJP; its backward raises.
* :func:`fused_coupling_bwd` is the one home of the coupling-backward
  dispatch: ``AffineCoupling.fused_bwd`` and the flow step's backward
  (``kernels/flowstep/ops.py``) both call it.

Inputs are (B, M, ca) views of the transformed half; a view whose channels
are not adjacent (or a ``raw``/``t`` pair with different strides) is made
contiguous first, the layout the kernels take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import use_plain
from repro_torch.kernels.coupling import coupling as _k
from repro_torch.kernels.coupling.ref import coupling_bwd_ref, coupling_fwd_ref, coupling_inv_ref


def _unit_channels(v, raw, t):
    """``(v, raw, t)`` in a layout the kernels take: unit channel stride, and
    ``raw``/``t`` sharing strides."""
    if v.stride(-1) != 1:
        v = v.contiguous()
    if raw.stride(-1) != 1 or raw.stride() != t.stride():
        raw, t = raw.contiguous(), t.contiguous()
    return v, raw, t


def _fwd(x, raw, t, clamp):
    if use_plain(x, raw, t):
        return coupling_fwd_ref(x, raw, t, clamp=clamp)
    return _k.coupling_fwd(*_unit_channels(x, raw, t), clamp)


def _inv(y, raw, t, clamp):
    if use_plain(y, raw, t):
        return coupling_inv_ref(y, raw, t, clamp=clamp)
    return _k.coupling_inv(*_unit_channels(y, raw, t), clamp)


def fused_coupling_bwd(y, raw, t, gy, gld, clamp: float = 2.0):
    """The coupling backward from the output side: ``(x, gx, graw, gt)``
    for y, raw, t, gy (B, M, ca) and gld (B,); graw/gt feed the
    conditioner's VJP."""
    if use_plain(y, raw, t, gy, gld):
        return coupling_bwd_ref(y, raw, t, gy, gld, clamp=clamp)
    y, raw, t = _unit_channels(y, raw, t)
    return _k.coupling_bwd(y, raw, t, gy if gy.stride(-1) == 1 else gy.contiguous(), gld, clamp)


class _FwdFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, raw, t, clamp):
        y, ld = _fwd(x, raw, t, clamp)
        ctx.save_for_backward(y, raw, t)
        ctx.clamp = clamp
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        y, raw, t = ctx.saved_tensors
        _x, gx, graw, gt = fused_coupling_bwd(y, raw, t, gy, gld, ctx.clamp)
        return gx, graw, gt, None


class _InvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, raw, t, clamp):
        return _inv(y, raw, t, clamp)

    @staticmethod
    def backward(ctx, gx):
        raise NotImplementedError(
            "coupling_inv has no gradient, as in the reference; "
            "differentiate the forward instead")


def fused_coupling_fwd(x, raw, t, clamp: float = 2.0):
    """``y = x*exp(log_s) + t`` and ``ld`` (B,) f32 on (B, M, ca):
    differentiable, from the output side."""
    return _FwdFn.apply(x, raw, t, clamp)


def fused_coupling_inv(y, raw, t, clamp: float = 2.0):
    """``x = (y - t)*exp(-log_s)`` on (B, M, ca) (the sampling path)."""
    return _InvFn.apply(y, raw, t, clamp)
