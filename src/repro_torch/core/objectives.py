"""Training objectives for flows (maximum likelihood, amortized VI)."""

from __future__ import annotations

import math

import torch

from repro_torch.core.distributions import flatten_state, std_normal_logpdf


def nll_bits_per_dim(flow, x, cond=None, n_bins: float = 256.0) -> torch.Tensor:
    """Negative log-likelihood in bits per dimension (image-flow convention)."""
    z, logdet = flow(x, cond)
    d = flatten_state(z).shape[1]
    ll = std_normal_logpdf(z) + logdet
    return torch.mean(-(ll / d - math.log(n_bins)) / math.log(2.0))


def nll_loss(flow, x, cond=None) -> torch.Tensor:
    """Mean negative log-likelihood per dimension."""
    z, logdet = flow(x, cond)
    d = flatten_state(z).shape[1]
    return -torch.mean(std_normal_logpdf(z) + logdet) / d


def amortized_vi_loss(flow, theta, y_obs, summary=None) -> torch.Tensor:
    """BayesFlow-style amortized posterior loss, -log q(theta | s(y)) per
    dimension.  ``summary`` is an arbitrary (non-invertible) network, its
    gradient taken by plain autograd, while the flow's comes from its own
    memory-frugal engine (the paper's section 4)."""
    cond = y_obs if summary is None else summary(y_obs)
    return nll_loss(flow, theta, cond)
