"""Containers composing ``Invertible`` layers, with memory-frugal gradients.

``InvertibleChain`` is itself an ``Invertible``, so chains nest; its forward
goes through ``core/autodiff.py::make_chain_apply`` for its ``grad_mode``.
The ``fused_bwd`` hooks here serve the ``coupled`` engine: a nested chain
reuses :func:`chain_backward`, ``OnFirst`` lifts its layer's hook onto the
tuple state, and ``Split``/``Pack`` reshuffle the cotangents as they
reshuffle the state.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
from torch import nn

from repro_torch.core.autodiff import CHAIN_MODES, chain_backward, make_chain_apply
from repro_torch.core.types import Invertible, zero_logdet


class InvertibleChain(Invertible):
    """``grad_mode`` is the engine asked for; ``engine`` the one that runs,
    when it differs (``"autodiff"`` for a ``coupled`` flow whose backward
    strategy is ``"stored"``, see ``core/glow_scan.py``).

    ``psum_axis`` (data parallelism, ``core/autodiff.py``): the backward
    sums the parameter gradients over that mesh axis.  Only the engines with
    a backward of their own reduce; ``self.psum_axis`` records the axis that
    takes effect (None under ``"autodiff"``), which ``dist/flow.py`` and the
    training loop read to skip a reduction of their own."""

    def __init__(self, layers: Sequence[Invertible], grad_mode: str = "invertible",
                 engine: str | None = None, psum_axis: str | None = None):
        super().__init__()
        for mode in (grad_mode, engine or grad_mode):
            if mode not in CHAIN_MODES:
                raise ValueError(f"grad_mode must be one of {CHAIN_MODES}, got {mode}")
        self.layers = nn.ModuleList(layers)
        self.grad_mode = grad_mode
        self.engine = engine or grad_mode
        self.psum_axis = psum_axis if self.engine in ("invertible", "coupled") else None

    def forward(self, x, cond=None):
        return make_chain_apply(self.layers, self.engine, psum_axis=self.psum_axis)(x, cond)

    def inverse(self, y, cond=None):
        for layer in reversed(self.layers):
            y = layer.inverse(y, cond)
        return y

    def fused_bwd(self, y, gy, gld, cond=None):
        """A nested chain inside a coupled chain: the same reverse walk, so
        every inner layer's own hook engages."""
        x, gx, gparams, gcond = chain_backward(self.layers, y, gy, gld, cond, use_fused=True)
        return x, gx, {f"layers.{k}.{n}": g for k, gp in enumerate(gparams)
                       for n, g in gp.items()}, gcond


class OnFirst(Invertible):
    """Lift an array-level layer to act on element 0 of a tuple state.  It
    offers its layer's ``fused_bwd`` / ``invertible_bwd`` hooks, and only
    those its layer has."""

    _HOOKS = ("fused_bwd", "invertible_bwd")

    def __init__(self, layer: Invertible):
        super().__init__()
        self.layer = layer

    def forward(self, state, cond=None):
        y0, ld = self.layer(state[0], cond)
        return (y0,) + tuple(state[1:]), ld

    def inverse(self, state, cond=None):
        return (self.layer.inverse(state[0], cond),) + tuple(state[1:])

    def __getattr__(self, name):
        if name in OnFirst._HOOKS and hasattr(self._modules.get("layer"), name):
            return partial(self._lifted, name)
        return super().__getattr__(name)

    def _lifted(self, hook, state, gstate, gld, cond=None):
        x0, gx0, gp, gc = getattr(self.layer, hook)(state[0], gstate[0], gld, cond)
        return ((x0,) + tuple(state[1:]), (gx0,) + tuple(gstate[1:]),
                {f"layer.{n}": g for n, g in gp.items()}, gc)


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

    def fused_bwd(self, state, gstate, gld, cond=None):
        """A reshuffle of the state, so the backward reshuffles the cotangents."""
        x = self.inverse(state, cond)
        gx = torch.cat([gstate[0].to(x[0].dtype), gstate[-1].to(x[0].dtype)], dim=-1)
        return x, (gx,) + tuple(gstate[1:-1]), {}, None


class Pack(Invertible):
    """Wrap an array into the 1-tuple state used by multiscale chains."""

    def forward(self, x, cond=None):
        return (x,), zero_logdet(x)

    def inverse(self, state, cond=None):
        (x,) = state
        return x

    def fused_bwd(self, state, gstate, gld, cond=None):
        (x,), (gx,) = state, gstate
        return x, gx, {}, None
