"""Affine and additive coupling layers (NICE, RealNVP).

The conditioner is an arbitrary, non-invertible ``nn.Module``
(``net(xb, cond) -> h``, e.g. ``nn/nets.py::CouplingCNN``); inside the
memory-frugal engines it is differentiated locally by autograd.  Log-scales
are soft-clamped, ``log_s = clamp * tanh(raw / clamp)``, so the inverse stays
stable at any stage of training.

The options keep the reference's meaning (``repro/core/coupling.py``).  With
a kernel flag off the layer computes with plain torch ops; with it on, CPU
tensors take the kernel's plain version and CUDA tensors the kernel:

* ``kernel_training`` - the forward goes through ``fused_coupling_fwd_rows``
  (differentiable from its output side), which writes the layer's whole
  output row, and :meth:`fused_bwd` through ``fused_coupling_bwd_rows``,
  which writes the backward's whole rows;
* ``kernel_inverse`` - the inverse (sampling) goes through
  ``fused_coupling_inv_rows``.

:meth:`fused_bwd` is the ``grad_mode="coupled"`` hook: it rebuilds the input
from the output and emits every cotangent with one conditioner evaluation
(the generic invert-then-VJP step needs two).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.types import Invertible, zero_logdet
from repro_torch.kernels.common import flatten_bmc
from repro_torch.kernels.coupling.ops import (
    fused_coupling_bwd_rows,
    fused_coupling_fwd_rows,
    fused_coupling_inv_rows,
)
from repro_torch.kernels.coupling.ref import coupling_bwd_rows_ref


class AffineCoupling(Invertible):
    """Split the trailing dim into (xa, xb) and transform xa conditioned on
    xb: ``ya = xa * exp(log_s) + t`` with ``(raw, t) = net(xb, cond)``.

    Args:
      net: the conditioner, mapping xb (``c - ca`` channels) to ``2 * ca``
        channels (``ca`` with ``additive``), where ``ca`` is the transformed
        half's width: ``c // 2``, or ``c - c // 2`` with ``flip``.  Its
        parameters appear under ``net.`` as in the reference's tree.
      flip: transform the second half instead of the first.
      additive: NICE-style shift-only coupling (logdet 0).
      clamp: soft-clamp bound of the log-scales.
      kernel_inverse: the inverse through the fused coupling kernel.
      kernel_training: the forward and the coupled backward through the
        fused coupling kernels.
    """

    def __init__(self, net: nn.Module, flip: bool = False, additive: bool = False,
                 clamp: float = 2.0, kernel_inverse: bool = False,
                 kernel_training: bool = False):
        super().__init__()
        self.net = net
        self.flip = flip
        self.additive = additive
        self.clamp = clamp
        self.kernel_inverse = kernel_inverse
        self.kernel_training = kernel_training

    def _split(self, x):
        ca = x.shape[-1] // 2
        xa, xb = x[..., :ca], x[..., ca:]
        return (xb, xa) if self.flip else (xa, xb)

    def _merge(self, xa, xb):
        return torch.cat([xb, xa] if self.flip else [xa, xb], dim=-1)

    def forward(self, x, cond=None):
        xa, xb = self._split(x)
        h = self.net(xb, cond)
        if self.additive:
            return self._merge(xa + h, xb), zero_logdet(x)
        if self.kernel_training:  # the whole output row, merged by the op
            y, ld = fused_coupling_fwd_rows(flatten_bmc(x), flatten_bmc(h), flip=self.flip,
                                            clamp=self.clamp)
            return y.reshape(x.shape), ld
        ca = xa.shape[-1]
        raw, t = h[..., :ca], h[..., ca:]
        log_s = self.clamp * torch.tanh(raw / self.clamp)
        ld = torch.sum(log_s.float(), dim=tuple(range(1, log_s.ndim)))
        return self._merge(xa * torch.exp(log_s) + t, xb), ld

    def inverse(self, y, cond=None):
        ya, yb = self._split(y)
        h = self.net(yb, cond)
        if self.additive:
            return self._merge(ya - h, yb)
        if self.kernel_inverse:  # the whole input row, merged by the op
            return fused_coupling_inv_rows(flatten_bmc(y), flatten_bmc(h), flip=self.flip,
                                           clamp=self.clamp).reshape(y.shape)
        ca = ya.shape[-1]
        raw, t = h[..., :ca], h[..., ca:]
        xa = (ya - t) * torch.exp(-self.clamp * torch.tanh(raw / self.clamp))
        return self._merge(xa, yb)

    def fused_bwd(self, y, gy, gld, cond=None):
        """The fused reversible backward from the output side: ``(x, gx,
        {name: grad}, gcond)``.  The conditioner runs once, and one
        ``autograd.grad`` through it takes the cotangent of h = ``(raw | t)``
        that the coupling backward emits while it rebuilds the input row
        (the kernel's op with ``kernel_training``, else its plain version);
        the conditioner's cotangent of the pass-through half is added into
        that half of the row cotangent in place."""
        ya, yb = self._split(y)
        names, params = zip(*self.net.named_parameters())
        with torch.enable_grad():
            yb_ = yb.detach().requires_grad_()
            c_ = cond.detach().requires_grad_() if cond is not None and cond.is_floating_point() else None
            h = self.net(yb_, cond if c_ is None else c_)
        inputs = [*params, yb_, *([c_] if c_ is not None else [])]
        if self.additive:
            gya, gyb = self._split(gy)
            grads = torch.autograd.grad(h, inputs, gya.to(h.dtype), allow_unused=True)
            gxb = gyb.to(yb.dtype) + grads[len(params)].to(yb.dtype)
            x, gx = self._merge(ya - h.detach(), yb), self._merge(gya.to(y.dtype), gxb)
        else:  # the whole rows: x, gx (gy's pass-through half) and gh
            bwd = fused_coupling_bwd_rows if self.kernel_training else coupling_bwd_rows_ref
            # contiguous rows, as the row stream takes them (a chain's last
            # cotangent is a slice of the packed one)
            x, gx, gh = bwd(flatten_bmc(y.contiguous()), flatten_bmc(h.detach()),
                            flatten_bmc(gy.contiguous()), gld, flip=self.flip, clamp=self.clamp)
            x, gx = x.reshape(y.shape), gx.reshape(y.shape)
            grads = torch.autograd.grad(h, inputs, gh.reshape(h.shape).to(h.dtype),
                                        allow_unused=True)
            self._split(gx)[1].add_(grads[len(params)].to(gx.dtype))
        gcond = grads[-1] if c_ is not None else None
        gparams = {f"net.{n}": g for n, g in zip(names, grads)}
        return x, gx, gparams, gcond
