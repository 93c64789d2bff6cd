"""Containers composing ``Invertible`` layers.

``InvertibleChain`` is itself an ``Invertible``, so chains nest.  Forward and
inverse are the plain composition, which is what every ``grad_mode`` of the
reference computes going forward; the memory-frugal gradient engines
(``invertible``, ``coupled``) come with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.core.types import Invertible, zero_logdet

GRAD_MODES = ("invertible", "coupled", "autodiff")


class InvertibleChain(Invertible):
    def __init__(self, layers: Sequence[Invertible], grad_mode: str = "invertible"):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode}")
        self.layers = nn.ModuleList(layers)
        self.grad_mode = grad_mode

    def forward(self, x, cond=None):
        logdet = zero_logdet(x)
        for layer in self.layers:
            x, ld = layer(x, cond)
            logdet = logdet + ld.to(logdet.dtype)
        return x, logdet

    def inverse(self, y, cond=None):
        for layer in reversed(self.layers):
            y = layer.inverse(y, cond)
        return y


class OnFirst(Invertible):
    """Lift an array-level layer to act on element 0 of a tuple state."""

    def __init__(self, layer: Invertible):
        super().__init__()
        self.layer = layer

    def forward(self, state, cond=None):
        y0, ld = self.layer(state[0], cond)
        return (y0,) + tuple(state[1:]), ld

    def inverse(self, state, cond=None):
        return (self.layer.inverse(state[0], cond),) + tuple(state[1:])


class Split(Invertible):
    """GLOW factor-out: move half the channels of the working tensor into the
    carried tuple of latents.  State: ``(x, z_1, ..., z_k)``."""

    def forward(self, state, cond=None):
        x = state[0]
        c = x.shape[-1] // 2
        return (x[..., :c],) + tuple(state[1:]) + (x[..., c:],), zero_logdet(x)

    def inverse(self, state, cond=None):
        x = torch.cat([state[0], state[-1]], dim=-1)
        return (x,) + tuple(state[1:-1])


class Pack(Invertible):
    """Wrap an array into the 1-tuple state used by multiscale chains."""

    def forward(self, x, cond=None):
        return (x,), zero_logdet(x)

    def inverse(self, state, cond=None):
        (x,) = state
        return x
