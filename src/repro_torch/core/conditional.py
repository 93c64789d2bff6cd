"""Conditional flows for amortized Bayesian inference (the paper's section 4),
the port of the reference's ``core/conditional.py``.

``ConditionalFlow`` pairs an invertible flow over parameters ``theta`` with an
arbitrary (non-invertible) summary network over observations ``y``, the
BayesFlow pattern.  The summary network is differentiated by plain autograd,
the flow by its memory-frugal engine, both in one backward: the flow's
engine hands the summary output its cotangent (``gcond``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.actnorm import ActNorm
from repro_torch.core.chain import InvertibleChain
from repro_torch.core.conv1x1 import Conv1x1
from repro_torch.core.distributions import derive_key, std_normal_logpdf, std_normal_sample
from repro_torch.core.hint import HINTCoupling
from repro_torch.core.objectives import nll_loss
from repro_torch.core.types import resolve_device, share_parameters, to_device
from repro_torch.dist.flow import gather_batch, shard_batch
from repro_torch.nn.nets import CouplingMLP


def build_chint(d_theta: int, d_cond: int = 0, depth: int = 4, recursion: int = 2,
                hidden: int = 128, grad_mode: str = "invertible", kernel_inverse: bool = False,
                *, generator: torch.Generator | None = None, device=None) -> InvertibleChain:
    """Conditional HINT: ``depth`` x (``ActNorm``, ``Conv1x1``,
    ``HINTCoupling``) over ``d_theta`` features, each cross conditioner a
    ``CouplingMLP`` (2 hidden layers of ``hidden``) that also reads a
    ``d_cond``-wide condition.

    The reference reads d_theta and d_cond from the example it is
    initialised with; port modules take their widths at construction, so
    both are arguments here.  ``kernel_inverse`` sends every cross inverse
    through the fused coupling kernel (the sampling path); the cross
    backward of the ``coupled`` engine always goes through
    ``coupling_bwd``.  Parameters are drawn
    from ``generator`` on the CPU, in layer order, then moved to ``device``
    (``cuda`` unless named; raises without a card)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def conditioner(d_in, d_out):
        return CouplingMLP(d_in, d_out, hidden=hidden, depth=2, generator=gen, device=dev)

    layers = []
    for _ in range(depth):
        layers += [ActNorm(d_theta, device=dev), Conv1x1(d_theta, generator=gen, device=dev),
                   HINTCoupling(conditioner, d_theta, d_cond, depth=recursion,
                                kernel_inverse=kernel_inverse)]
    return InvertibleChain(layers, grad_mode=grad_mode)


class SummaryMLP(CouplingMLP):
    """Summary network: observations (B, ...) flattened to (B, d_in), then an
    MLP to ``d_out`` features (replace at will: anything differentiable
    works).  Its parameters are ``layers.{i}.w`` / ``.b``, the reference's
    tree."""

    def __init__(self, d_in: int, d_out: int = 64, hidden: int = 128, depth: int = 2, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(d_in, d_out, hidden=hidden, depth=depth, generator=generator,
                         device=device)

    def forward(self, y):
        return super().forward(y.reshape(y.shape[0], -1))


class ConditionalFlow(nn.Module):
    """flow(theta; cond = summary(y)) with an exact posterior density, on
    ``device`` (``cuda`` unless named; raises without a card).

    ``sample_flow``: an optional twin of ``flow`` for the sampling paths, the
    same layers with other kernel options (``build_chint(...,
    kernel_inverse=True)``), so the wide repeated-``cond`` batches of
    posterior sampling run through the fused inverse kernel.  It must mirror
    ``flow`` layer for layer; it is made to hold ``flow``'s own parameters
    (``core.types.share_parameters``) and is not a submodule, so the
    parameters (``named_parameters()``, ``state_dict()``) are ``flow.*`` and
    ``summary.*`` once each, as in the reference's ``{"flow", "summary"}``.

    Sampling: each method derives its noise stream from the caller's
    generator by ``derive_key`` with a tag of its own (0 for ``sample`` and
    ``posterior_sampler``, 1 for ``sample_like``), so the same generator
    seed gives the same draws on a device, and the two never alias.

    ``mesh``: a data-parallel mesh (one process per rank, each calling with
    the whole batch).  ``log_prob`` and the sampling paths run each rank's
    rows and gather the outputs, so every rank returns the whole batch;
    latent noise is drawn at the whole batch's extent before the rows are
    taken, so the draws are the same on any mesh.  Training shards through
    the loop (``train_conditional_flow(mesh=...)``), not here.
    """

    _TAG_SAMPLE = 0
    _TAG_SAMPLE_LIKE = 1

    def __init__(self, flow: InvertibleChain, summary: nn.Module | None = None,
                 sample_flow: InvertibleChain | None = None, *, device=None, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        object.__setattr__(self, "mesh", mesh)
        self.flow = flow
        self.summary = summary
        if sample_flow is not None:
            mine = [type(layer).__name__ for layer in flow.layers]
            theirs = [type(layer).__name__ for layer in sample_flow.layers]
            if mine != theirs:
                raise ValueError("sample_flow must mirror flow layer for layer (it shares "
                                 f"flow's parameters); got {mine} vs {theirs}")
        object.__setattr__(self, "_sample_flow", sample_flow if sample_flow is not None else flow)
        self.to(dev)

    @property
    def sample_flow(self) -> InvertibleChain:
        return self._sample_flow

    def _apply(self, fn, recurse=True):
        # moving the module replaces its buffers: the twin takes them again
        super()._apply(fn, recurse)
        if self._sample_flow is not self.flow:
            share_parameters(self._sample_flow.to(next(self.flow.parameters()).device), self.flow)
        return self

    @property
    def device(self) -> torch.device:
        return next(self.flow.parameters()).device

    def _cond(self, y):
        y = to_device(y, self.device)
        return y if self.summary is None else self.summary(y)

    def log_prob(self, theta, y) -> torch.Tensor:
        """log q(theta | y) per example."""
        full = theta.shape[0]
        theta, y = shard_batch((to_device(theta, self.device), to_device(y, self.device)),
                               self.mesh)
        z, logdet = self.flow(theta, self._cond(y))
        return gather_batch(std_normal_logpdf(z) + logdet, self.mesh, full)

    def _inverse(self, z, cond):
        """``sample_flow.inverse`` over this rank's rows, gathered."""
        full = z.shape[0]
        z, cond = shard_batch((z, cond), self.mesh)
        return gather_batch(self.sample_flow.inverse(z, cond), self.mesh, full)

    def loss(self, theta, y) -> torch.Tensor:
        """Mean negative log posterior density per dimension."""
        return nll_loss(self.flow, to_device(theta, self.device), self._cond(y))

    def train_loss(self, batch):
        """The supervised loop's objective (``train.loop.train_conditional_flow``):
        ``batch`` is the ``{"theta", "y"}`` dict the inverse-problem sources
        emit.  Returns ``(loss, {})``."""
        return self.loss(batch["theta"], batch["y"]), {}

    def sample(self, generator: torch.Generator, y, n: int, theta_dim: int) -> torch.Tensor:
        """``n`` posterior draws per observation in ``y``, grouped by
        observation ((n_obs * n, theta_dim)), through ``sample_flow`` in one
        inverse call."""
        return self.posterior_sampler(y, theta_dim=theta_dim)(generator, n)

    def sample_like(self, generator: torch.Generator, y, theta_like):
        """One draw per observation, shaped like ``theta_like`` (only its
        shapes and dtypes are read)."""
        with torch.no_grad():
            cond = self._cond(y)
            z = std_normal_sample(derive_key(generator, self._TAG_SAMPLE_LIKE, self.device),
                                  theta_like)
            return self._inverse(z, cond)

    def posterior_sampler(self, y, *, theta_dim: int):
        """``draw(generator, n)`` -> ``n`` posterior draws per observation in
        ``y``, (n_obs * n, theta_dim).  ``summary(y)`` is computed once,
        here, and reused by every draw.  ``draw(g, n)`` equals ``sample(g,
        y, n, theta_dim)`` bit for bit.  (The reference's ``theta_like``
        prototype, for image posteriors, comes with a conditional image
        flow.)"""
        with torch.no_grad():
            cond0 = self._cond(y)

        def draw(generator: torch.Generator, n: int):
            with torch.no_grad():
                cond = cond0.repeat_interleave(n, dim=0)
                z = std_normal_sample(derive_key(generator, self._TAG_SAMPLE, self.device),
                                      torch.empty((cond.shape[0], theta_dim), device="meta"))
                return self._inverse(z, cond)

        return draw
