"""Simulation-based calibration (SBC) and coverage diagnostics, the port of
the reference's ``repro/uq/calibration.py``.

An amortized posterior is sampleable the moment training converges; it is
trustworthy only if it is calibrated.  The standard diagnostics (Talts et
al. 2018; Papamakarios et al. 2019):

* **SBC rank histograms** - for ``theta* ~ prior``, ``y ~ F(theta*)``, the
  rank of ``theta*`` among L posterior draws is uniform on {0..L} iff the
  posterior is calibrated; uniformity is scored with a chi-square statistic
  (its p-value by the Wilson-Hilferty normal approximation);
* **empirical coverage curves** - the fraction of ``theta*`` inside the
  central q-credible interval must be q, for every q;
* a pass/fail :class:`CalibrationReport` of both.

The host math is the reference's float64 numpy.  Samplers and simulators
take a ``torch.Generator``; every simulation chunk draws from its own
``derive_key`` stream of the caller's generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distributions import derive_key
from repro_torch.uq.operators import host64


def _host(v) -> np.ndarray:
    """A sampler's or simulator's output (a tensor on any device, or an
    array) as a numpy array of its own type."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def chi2_sf(x: float, df: int) -> float:
    """The chi-square survival function by the Wilson-Hilferty cube-root
    normal approximation (good to ~1e-3 for df >= 3, ample for a pass/fail
    gate)."""
    if df <= 0:
        return 1.0
    z = ((x / df) ** (1.0 / 3.0) - (1.0 - 2.0 / (9.0 * df))) / math.sqrt(2.0 / (9.0 * df))
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def _sim_chunks(sample_posterior, simulate, generator, n_sims: int, n_draws: int,
                sim_chunk: int):
    """Yield ``(theta (m, d), draws (m, n_draws, d))`` host arrays, ``m`` <=
    ``sim_chunk`` simulations at a time: chunk k simulates from
    ``derive_key(generator, 2k)`` and samples from ``2k + 1``, one sampler
    call for the chunk's observations."""
    done = k = 0
    while done < n_sims:
        m = min(sim_chunk, n_sims - done)
        theta, y = simulate(derive_key(generator, 2 * k), m)
        draws = _host(sample_posterior(derive_key(generator, 2 * k + 1), y, n_draws))
        yield _host(theta), draws.reshape(m, n_draws, -1)
        done += m
        k += 1


def sbc_ranks(sample_posterior, simulate, generator, *, n_sims: int = 128,
              n_draws: int = 64, sim_chunk: int = 32) -> np.ndarray:
    """(n_sims, d_theta) SBC ranks.

    ``simulate(generator, n) -> (theta (n, d), y (n, d_y))`` draws from the
    joint (``ForwardOperator.simulate``); ``sample_posterior(generator, y, n)
    -> (N * n, d)`` draws n posterior samples per observation row, grouped
    by observation (``ConditionalFlow.sample``'s layout).  Simulations run
    in chunks of ``sim_chunk`` observations, one sampler call each, so the
    (chunk, n_draws, d) block is the largest thing materialised."""
    return np.concatenate([
        (draws < theta[:, None, :]).sum(axis=1)
        for theta, draws in _sim_chunks(sample_posterior, simulate, generator, n_sims, n_draws,
                                        sim_chunk)], axis=0)


def _rank_bins(n_draws: int, n_bins: int):
    """Bin edges over the n_draws + 1 rank values, and the fraction of the
    values each bin covers: the count rarely divides ``n_bins`` (65 values
    in 8 bins make one bin of 9), so the expected count under uniformity is
    per bin; equal bins would inflate the statistic linearly in the number
    of simulations and fail calibrated posteriors at large budgets."""
    edges = np.linspace(0, n_draws + 1, n_bins + 1)
    per_bin, _ = np.histogram(np.arange(n_draws + 1), bins=edges)
    return edges, per_bin / (n_draws + 1)


def rank_histogram(ranks: np.ndarray, n_draws: int, n_bins: int = 8):
    """The rank histogram pooled over dimensions: (counts (n_bins,),
    expected (n_bins,))."""
    flat = ranks.reshape(-1)
    edges, fractions = _rank_bins(n_draws, n_bins)
    counts, _ = np.histogram(flat, bins=edges)
    return counts, flat.size * fractions


def uniformity_pvalues(ranks: np.ndarray, n_draws: int, n_bins: int = 8):
    """Per-dimension chi-square uniformity p-values of the rank histograms."""
    edges, fractions = _rank_bins(n_draws, n_bins)
    expected = ranks.shape[0] * fractions
    out = []
    for d in range(ranks.shape[1]):
        counts, _ = np.histogram(ranks[:, d], bins=edges)
        out.append(chi2_sf(float(((counts - expected) ** 2 / expected).sum()), n_bins - 1))
    return np.asarray(out)


def coverage_curve(sample_posterior, simulate, generator, *, levels=(0.5, 0.8, 0.9, 0.95),
                   n_sims: int = 128, n_draws: int = 128, sim_chunk: int = 32):
    """Empirical central-credible-interval coverage at each level, averaged
    over dimensions: ``{level: fraction of theta* inside}``."""
    inside = {float(lvl): 0 for lvl in levels}
    total = 0
    for theta, draws in _sim_chunks(sample_posterior, simulate, generator, n_sims, n_draws,
                                    sim_chunk):
        for lvl in inside:
            lo = np.quantile(draws, (1 - lvl) / 2, axis=1)
            hi = np.quantile(draws, 1 - (1 - lvl) / 2, axis=1)
            inside[lvl] += int(((theta >= lo) & (theta <= hi)).sum())
        total += theta.size
    return {lvl: c / total for lvl, c in inside.items()}


@dataclass
class CalibrationReport:
    """A pass/fail calibration verdict with its evidence."""

    ranks: np.ndarray      # (n_sims, d_theta)
    n_draws: int
    pvalues: np.ndarray    # per-dimension chi-square uniformity
    histogram: np.ndarray  # the pooled rank histogram's counts
    coverage: dict         # level -> empirical coverage
    alpha: float           # the per-dimension p-value floor
    coverage_tol: float    # the |empirical - nominal| ceiling
    passed: bool = False

    def __post_init__(self):
        self.passed = bool(np.all(self.pvalues > self.alpha) and all(
            abs(c - lvl) <= self.coverage_tol for lvl, c in self.coverage.items()))

    def summary(self) -> str:
        lines = [
            f"calibration: {'PASS' if self.passed else 'FAIL'} "
            f"(n_sims={self.ranks.shape[0]}, n_draws={self.n_draws}, "
            f"d_theta={self.ranks.shape[1]})",
            f"  SBC uniformity p-values: min {self.pvalues.min():.3f} "
            f"(floor {self.alpha}) over {self.pvalues.size} dims",
        ]
        for lvl, cov in sorted(self.coverage.items()):
            flag = "" if abs(cov - lvl) <= self.coverage_tol else "  <-- off"
            lines.append(f"  coverage @ {lvl:.2f}: {cov:.3f}{flag}")
        return "\n".join(lines)


def calibrate(sample_posterior, simulate, generator: torch.Generator | None = None, *,
              n_sims: int = 128, n_draws: int = 64, n_bins: int = 8, levels=(0.5, 0.8, 0.9),
              alpha: float = 0.01, coverage_tol: float = 0.08,
              sim_chunk: int = 32) -> CalibrationReport:
    """The calibration suite against a posterior sampler.

    ``alpha`` / ``coverage_tol`` are loose gates sized for small budgets
    (n_sims ~ 10^2): a calibrated posterior passes with overwhelming
    probability, one over- or under-confident by ~25 % or more reliably
    fails."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    ranks = sbc_ranks(sample_posterior, simulate, derive_key(generator, 0), n_sims=n_sims,
                      n_draws=n_draws, sim_chunk=sim_chunk)
    hist, _ = rank_histogram(ranks, n_draws, n_bins)
    pvals = uniformity_pvalues(ranks, n_draws, n_bins)
    # intervals estimated from few draws are noisy enough to bias coverage
    # down: the coverage pass takes a larger draw budget than SBC
    cov = coverage_curve(sample_posterior, simulate, derive_key(generator, 1), levels=levels,
                         n_sims=n_sims, n_draws=max(n_draws, 128), sim_chunk=sim_chunk)
    return CalibrationReport(ranks=ranks, n_draws=n_draws, pvalues=pvals, histogram=hist,
                             coverage=cov, alpha=alpha, coverage_tol=coverage_tol)


def analytic_posterior_sampler(op):
    """The exact ``(generator, y, n) -> (N * n, d)`` sampler of a linear
    operator's closed-form posterior: the calibration suite's ground truth,
    in ``ConditionalFlow.sample``'s layout (grouped by observation).  Float64
    host math (the posterior mean is ``y @ gain`` with a covariance that does
    not depend on y, so one Cholesky serves every draw); f32 draws."""
    _, cov = op.analytic_posterior(np.zeros(op.d_y))
    chol = np.linalg.cholesky(cov + 1e-12 * np.eye(op.d_theta))
    gain = host64(op.matrix).T @ cov / op.sigma**2  # (d_y, d_theta): mu(y) = y @ gain

    def draw(generator, y, n: int):
        y2 = np.atleast_2d(host64(y))
        eps = torch.randn((y2.shape[0], n, op.d_theta), generator=derive_key(generator, 0),
                          dtype=torch.float64).numpy()
        draws = (y2 @ gain)[:, None, :] + eps @ chol.T
        return draws.reshape(y2.shape[0] * n, op.d_theta).astype(np.float32)

    return draw
