"""Fully hyperbolic (leapfrog) invertible layers (Lensink, Peters, Haber), the
port of the reference's ``repro/core/hyperbolic.py``.

A second-order telegraph-equation discretization,

    x_{t+1} = 2 x_t - x_{t-1} - alpha * K^T sigma(K x_t),

on the state pair ``(x_prev, x_cur)``.  The map ``(x_prev, x_cur) ->
(x_cur, x_next)`` is exactly invertible whatever the nonlinearity and
volume-preserving (logdet 0), so a deep hyperbolic network trains in O(1)
activation memory under the same engines as the flows.  The state is a
2-tuple of (B, D) or NHWC (B, H, W, C) tensors, as a multiscale flow's tuple
state is.
"""

from __future__ import annotations

import torch

from repro_torch.core.chain import InvertibleChain
from repro_torch.core.types import Invertible, ParamTree, resolve_device
from repro_torch.nn.conv import conv2d_apply, conv2d_init
from repro_torch.nn.linear import dense_apply, dense_init


class HyperbolicLayer(Invertible):
    """One leapfrog step on the pair state ``(x_prev, x_cur)`` of ``c``
    channels: K a 3x3 convolution (``conv``, NHWC, "SAME" padding) or a
    dense layer, He-initialised, with a bias; its parameters are ``k.w`` /
    ``k.b``, the reference's tree."""

    def __init__(self, c: int, alpha: float = 0.25, conv: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.alpha = alpha
        self.conv = conv
        k = (conv2d_init(gen, c, c, 3, scale="he") if conv
             else dense_init(gen, c, c, bias=True, scale="he"))
        self.k = ParamTree(k).to(dev)

    def _op(self, k, x):
        """``alpha * K^T relu(K x)`` with K's parameters ``k``; K^T is the
        convolution by the spatially flipped kernel with its input and
        output channels swapped, and no bias (or ``h @ w^T``)."""
        h = torch.relu(conv2d_apply(k, x) if self.conv else dense_apply(k, x))
        if self.conv:
            kt = {"w": torch.flip(k["w"], dims=(0, 1)).transpose(2, 3),
                  "b": torch.zeros(x.shape[-1], dtype=k["b"].dtype, device=x.device)}
            return self.alpha * conv2d_apply(kt, h)
        return self.alpha * (h @ k["w"].to(x.dtype).T)

    def forward(self, state, cond=None):
        x_prev, x_cur = state
        x_next = 2.0 * x_cur - x_prev - self._op(self.k, x_cur)
        return (x_cur, x_next), torch.zeros(x_cur.shape[0], dtype=torch.float32,
                                            device=x_cur.device)

    def inverse(self, state, cond=None):
        x_cur, x_next = state
        x_prev = 2.0 * x_cur - x_next - self._op(self.k, x_cur)
        return (x_prev, x_cur)

    def fused_bwd(self, state, gstate, gld, cond=None):
        """The ``grad_mode="coupled"`` hook, the leapfrog transpose: the
        output pair is ``(y1, y2) = (x_cur, 2 x_cur - x_prev - op(x_cur))``,
        and both the rebuilt input and the cotangents need one evaluation of
        ``op`` at ``y1`` and its VJP (the generic invert-then-VJP step takes
        two evaluations)::

            x_prev = 2 y1 - y2 - op(y1)
            g_prev = -g2
            g_cur  = g1 + 2 g2 - J_op(y1)^T g2
        """
        y1, y2 = state
        g1, g2 = gstate
        names, params = zip(*self.k.named_parameters())
        with torch.enable_grad():
            xc = y1.detach().requires_grad_()
            op_val = self._op(self.k, xc)
        g2 = g2.to(y2.dtype)
        grads = torch.autograd.grad(op_val, [*params, xc], -g2)
        x_prev = (2.0 * y1 - y2 - op_val).detach()
        g_cur = g1.to(y1.dtype) + 2.0 * g2 + grads[-1].to(y1.dtype)
        gparams = {f"k.{n}": g for n, g in zip(names, grads)}
        return (x_prev, y1), (-g2, g_cur), gparams, None


def build_hyperbolic(c: int, depth: int = 8, alpha: float = 0.25, conv: bool = True,
                     grad_mode: str = "invertible", *,
                     generator: torch.Generator | None = None,
                     device=None) -> InvertibleChain:
    """A deep leapfrog network of ``depth`` layers over ``c`` channels, on
    the pair state ``(x_prev, x_cur)``.  Every layer is volume-preserving and
    exactly invertible, so the chain trains in O(1) activation memory under
    ``invertible`` and ``coupled``; under ``coupled`` each layer takes the
    fused leapfrog transpose (one ``op`` linearization a layer instead of
    two evaluations).  The reference reads ``c`` from its example; port
    modules take it at construction.  Parameters are drawn from
    ``generator`` on the CPU, layer by layer, then moved to ``device``
    (``cuda`` unless named; raises without a card)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return InvertibleChain(
        [HyperbolicLayer(c, alpha=alpha, conv=conv, generator=gen, device=dev)
         for _ in range(depth)],
        grad_mode=grad_mode,
    )
