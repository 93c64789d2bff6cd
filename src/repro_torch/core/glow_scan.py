"""Scanned GLOW: homogeneous flow-step stacks with layer-stacked parameters.

``GlowStepStack`` holds the parameters of one scale's ``k`` identical flow
steps (actnorm -> LU-parameterised 1x1 conv -> affine coupling with a
``CouplingCNN`` conditioner) stacked along a leading ``k`` axis, as the
reference does for ``lax.scan``.  PyTorch runs eagerly, so the scan is a
Python loop over ``k``.  Each step is one fused flow-step launch given the
conditioner's raw/t (``kernels/flowstep``); the conditioner's convolutions
stay with cuDNN.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.chain import InvertibleChain, OnFirst, Pack, Split
from repro_torch.core.conv1x1 import conv1x1_init, lu_weight, lu_weight_inv
from repro_torch.core.haar import HaarSqueeze, Squeeze
from repro_torch.core.types import (
    Invertible,
    ParamTree,
    resolve_device,
    stack_trees,
    tree_index,
)
from repro_torch.kernels.common import flatten_bmc
from repro_torch.kernels.flowstep.ops import fused_flowstep_fwd, fused_flowstep_inv
from repro_torch.nn.nets import coupling_cnn_apply, coupling_cnn_init


class GlowStepStack(Invertible):
    """``k_steps`` homogeneous GLOW flow steps on a (B, H, W, C) tensor (wrap
    in ``OnFirst`` for the multiscale tuple state).  Parameters: ``an``
    (log_s, b: (k, C)), ``lu`` (l, u: (k, C, C); log_s: (k, C); integer
    buffers inv_perm, sign_s: (k, C)) and ``net`` (the conditioner's conv1-3,
    each w: (k, kh, kw, c_in, c_out), b: (k, c_out))."""

    def __init__(self, c: int, k_steps: int, hidden: int = 64, clamp: float = 2.0, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        ca = c // 2
        if ca < 1:
            raise ValueError(f"GlowStepStack needs >= 2 channels, got {c}")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.k_steps = k_steps
        self.clamp = clamp
        steps = [
            {
                "an": {"log_s": torch.zeros(c), "b": torch.zeros(c)},
                "lu": conv1x1_init(gen, c),
                "net": coupling_cnn_init(gen, c - ca, 2 * ca, hidden),
            }
            for _ in range(k_steps)
        ]
        stacked = stack_trees(steps)
        self.an = ParamTree(stacked["an"])
        self.lu = ParamTree(stacked["lu"])
        self.net = ParamTree(stacked["net"])
        self.to(dev)

    # -- per-step pieces ----------------------------------------------------

    def _w(self, i: int) -> torch.Tensor:
        return lu_weight(tree_index(self.lu, i)).float()

    def _w_inv(self, i: int) -> torch.Tensor:
        return lu_weight_inv(tree_index(self.lu, i)).float()

    def _ld_const(self, i: int, x) -> torch.Tensor:
        """Per-batch-constant logdet: actnorm + conv1x1 (spatial * sum log_s)."""
        spatial = math.prod(x.shape[1:-1]) if x.ndim > 2 else 1
        return spatial * (torch.sum(self.an.log_s[i]) + torch.sum(self.lu.log_s[i])).float()

    def _step_fwd(self, i: int, x, cond):
        ca = x.shape[-1] // 2
        an_ls, an_b = self.an.log_s[i], self.an.b[i]
        w = self._w(i)
        # the conditioner input is the untransformed half after actnorm and
        # the 1x1 conv: a half-width product outside the kernel
        xb = (x.float() * torch.exp(an_ls) + an_b) @ w[:, ca:]
        h = coupling_cnn_apply(tree_index(self.net, i), xb.to(x.dtype), cond)
        y, ld_c = fused_flowstep_fwd(
            flatten_bmc(x.contiguous()), an_ls, an_b, w,
            flatten_bmc(h[..., :ca]), flatten_bmc(h[..., ca:]), clamp=self.clamp,
        )
        return y.reshape(x.shape), ld_c + self._ld_const(i, x)

    def _step_inv(self, i: int, y, cond):
        ca = y.shape[-1] // 2
        h = coupling_cnn_apply(tree_index(self.net, i), y[..., ca:], cond)
        x = fused_flowstep_inv(
            flatten_bmc(y.contiguous()), self.an.log_s[i], self.an.b[i], self._w_inv(i),
            flatten_bmc(h[..., :ca]), flatten_bmc(h[..., ca:]), clamp=self.clamp,
        )
        return x.reshape(y.shape)

    # -- Invertible surface -------------------------------------------------

    def forward(self, x, cond=None):
        ld = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for i in range(self.k_steps):
            x, ld_i = self._step_fwd(i, x, cond)
            ld = ld + ld_i
        return x, ld

    def inverse(self, y, cond=None):
        for i in reversed(range(self.k_steps)):
            y = self._step_inv(i, y, cond)
        return y


def build_glow_scanned(
    n_scales: int = 3,
    k_steps: int = 8,
    hidden: int = 64,
    grad_mode: str = "invertible",
    haar: bool = True,
    clamp: float = 2.0,
    *,
    channels: int = 3,
    generator: torch.Generator | None = None,
    device=None,
) -> InvertibleChain:
    """Scanned GLOW for (B, H, W, channels) inputs (H, W divisible by
    2**n_scales): per scale, squeeze -> one ``GlowStepStack`` of ``k_steps``
    steps -> split (but after the last scale).  The layer list, and so the
    parameter tree, is the reference's ``build_glow_scanned``.  Parameters
    are drawn from ``generator`` on the CPU, in layer order, then moved to
    ``device``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    squeeze = HaarSqueeze if haar else Squeeze
    layers: list[Invertible] = [Pack()]
    c = channels
    for scale in range(n_scales):
        c *= 4
        layers.append(OnFirst(squeeze()))
        layers.append(OnFirst(GlowStepStack(c, k_steps, hidden=hidden, clamp=clamp,
                                            generator=gen, device=dev)))
        if scale != n_scales - 1:
            layers.append(Split())
            c //= 2
    return InvertibleChain(layers, grad_mode=grad_mode)
