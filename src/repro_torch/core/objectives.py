"""Training objectives for flows (maximum likelihood)."""

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
