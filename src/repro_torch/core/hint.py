"""HINT: hierarchical invertible neural transport (Kruse et al.), the port of
the reference's ``core/hint.py``.

A recursive coupling over the trailing dimension: the input is split in
half, each half is transformed recursively, and the second half is also
coupled on the first.  The Jacobian is block-triangular, so the logdet is the
sum of the cross couplings' log-scales.  A node of width ``c < 4``, or at
depth 0, is the identity.  The conditional variant (every cross conditioner
also reads ``cond``) is the paper's Bayesian-inference workhorse.

Each node is a module: ``cross`` (the conditioner of the cross coupling,
mapping ``xa`` (+ cond) to h = ``(raw | t)``, ``2 cb`` wide), ``a`` and ``b``
(the child nodes of the two halves); a leaf holds nothing.  Parameter names
read like the reference's tree (``cross.layers.0.w``, ``a.cross...``).

The cross coupling's kernels are the coupling op's half contract, h
``2 cb`` wide against a ``cb``-wide half, on the row ops of
``kernels/coupling/ops.py``; CPU tensors take the kernel's plain version and
CUDA tensors the kernel:

* each cross backward of :meth:`fused_bwd` (the ``coupled`` engine) goes
  through ``fused_coupling_bwd_rows``, which hands back h's cotangent
  ``(graw | gt)`` as the conditioner's VJP takes it;
* with ``kernel_inverse``, each cross inverse goes through
  ``fused_coupling_inv_rows`` (the batched-sampling path of
  ``ConditionalFlow.sample``).

The forward is plain math, as in the reference: it launches no kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.types import Invertible, zero_logdet
from repro_torch.kernels.common import flatten_bmc
from repro_torch.kernels.coupling.ops import fused_coupling_bwd_rows, fused_coupling_inv_rows


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class HINTCoupling(Invertible):
    """One recursive HINT coupling block over a ``c``-wide trailing dimension.

    Args:
      conditioner: ``conditioner(d_in, d_out) -> nn.Module``, the cross
        conditioner of a node (``nn/nets.py::CouplingMLP``); ``d_in`` counts
        the condition's ``d_cond`` features, which the node concatenates to
        ``xa`` before the call.
      c: the width the block transforms.
      d_cond: the width of ``cond`` (0 for an unconditional block).
      depth: recursion depth; 0 (or ``c < 4``) makes the identity leaf.
      clamp: soft-clamp bound, ``log_s = clamp * tanh(raw / clamp)``.
      kernel_inverse: see the module note.
    """

    def __init__(self, conditioner: Callable, c: int, d_cond: int = 0, depth: int = 2,
                 clamp: float = 2.0, kernel_inverse: bool = False):
        super().__init__()
        self.clamp = clamp
        self.kernel_inverse = kernel_inverse
        self.is_leaf = depth == 0 or c < 4
        if self.is_leaf:
            return
        ca = c // 2
        cb = c - ca
        self.cross = conditioner(ca + d_cond, 2 * cb)
        kw = dict(clamp=clamp, kernel_inverse=kernel_inverse)
        self.a = HINTCoupling(conditioner, ca, d_cond, depth - 1, **kw)
        self.b = HINTCoupling(conditioner, cb, d_cond, depth - 1, **kw)

    # -- the cross coupling ----------------------------------------------------
    def _cross_h(self, xa, cond):
        """The cross conditioner's raw output h = ``(raw | t)``."""
        c_in = xa if cond is None else torch.cat([xa, cond.to(xa.dtype)], dim=-1)
        return self.cross(c_in)

    def _h_to_ls_t(self, h):
        cb = h.shape[-1] // 2
        return self.clamp * torch.tanh(h[..., :cb] / self.clamp), h[..., cb:]

    # -- bijection -------------------------------------------------------------
    def forward(self, x, cond=None):
        if self.is_leaf:
            return x, zero_logdet(x)
        ca = x.shape[-1] // 2
        xa, xb = x[..., :ca], x[..., ca:]
        ya, ld_a = self.a(xa, cond)
        log_s, t = self._h_to_ls_t(self._cross_h(ya, cond))
        xb = xb * torch.exp(log_s) + t
        ld_x = torch.sum(log_s.float(), dim=tuple(range(1, log_s.ndim)))
        yb, ld_b = self.b(xb, cond)
        return torch.cat([ya, yb], dim=-1), ld_a + ld_x + ld_b

    def inverse(self, y, cond=None):
        if self.is_leaf:
            return y
        ca = y.shape[-1] // 2
        ya, yb = y[..., :ca], y[..., ca:]
        xb_mid = self.b.inverse(yb, cond)
        h = self._cross_h(ya, cond)
        if self.kernel_inverse:  # the half contract: h is 2 cb wide
            xb = fused_coupling_inv_rows(flatten_bmc(xb_mid), flatten_bmc(h),
                                         clamp=self.clamp).reshape(xb_mid.shape)
        else:
            log_s, t = self._h_to_ls_t(h)
            xb = (xb_mid - t) * torch.exp(-log_s)
        xa = self.a.inverse(ya, cond)
        return torch.cat([xa, xb], dim=-1)

    # -- grad_mode="coupled" hook ----------------------------------------------
    def fused_bwd(self, y, gy, gld, cond=None):
        """The fused reversible backward: ``(x, gx, {name: grad}, gcond)``.

        Walks the tree in the reverse order of the forward (the b-subtree,
        the cross coupling, the a-subtree).  Each cross conditioner runs
        once: its output h serves the coupling backward, which rebuilds
        ``xb`` and emits h's cotangent (``fused_coupling_bwd_rows``), and one
        ``autograd.grad`` through it.  ``gcond`` sums over every node: it is
        what reaches the summary network of a ``ConditionalFlow``."""
        return self._fused_bwd_node(y, gy, gld.float(), cond)

    def _fused_bwd_node(self, y, gy, gld, cond):
        # separate from the public hook, so a counter wrapped around
        # ``fused_bwd`` sees one call per chain layer, not one per node
        if self.is_leaf:  # identity: the cotangents pass through
            return y, gy, {}, None
        ca = y.shape[-1] // 2
        ya, yb = y[..., :ca], y[..., ca:]
        gya, gyb = gy[..., :ca], gy[..., ca:]
        # 1. the b-subtree: the coupled middle state and its cotangent
        xb_mid, gxb_mid, gp_b, gc_b = self.b._fused_bwd_node(yb, gyb, gld, cond)
        # 2. the cross coupling, one conditioner evaluation
        names, params = zip(*self.cross.named_parameters())
        with torch.enable_grad():
            ya_ = ya.detach().requires_grad_()
            c_ = (cond.detach().requires_grad_() if cond is not None
                  and cond.is_floating_point() else None)
            h = self._cross_h(ya_, cond if c_ is None else c_)
        xb, gxb, gh = fused_coupling_bwd_rows(flatten_bmc(xb_mid.contiguous()), flatten_bmc(h.detach()),
                          flatten_bmc(gxb_mid.to(xb_mid.dtype).contiguous()), gld,
                          clamp=self.clamp)
        inputs = [*params, ya_, *([c_] if c_ is not None else [])]
        grads = torch.autograd.grad(h, inputs, gh.reshape(h.shape).to(h.dtype),
                                    allow_unused=True)
        # 3. the a-subtree: ya's cotangent from the output and from the conditioner
        gya_tot = gya.to(ya.dtype) + grads[len(params)].to(ya.dtype)
        xa, gxa, gp_a, gc_a = self.a._fused_bwd_node(ya, gya_tot, gld, cond)
        x = torch.cat([xa, xb.reshape(xb_mid.shape)], dim=-1)
        gx = torch.cat([gxa.to(x.dtype), gxb.reshape(xb_mid.shape).to(x.dtype)], dim=-1)
        gparams = {f"cross.{n}": g for n, g in zip(names, grads)}
        gparams.update({f"a.{n}": g for n, g in gp_a.items()})
        gparams.update({f"b.{n}": g for n, g in gp_b.items()})
        gcond = _add(_add(gc_b, grads[-1] if c_ is not None else None), gc_a)
        return x, gx, gparams, gcond
