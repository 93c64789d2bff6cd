"""Forward operators for synthetic Bayesian inverse problems, the port of the
reference's ``repro/uq/operators.py``.

The paper's applications (seismic imaging, medical imaging, CO2 monitoring)
are all "recover theta from y = F(theta) + noise" problems solved by amortized
conditional flows.  This module is the synthetic stand-in for F: a small
library of linear-Gaussian operators, each with

* ``apply(theta)`` - the forward map, ``theta @ matrix``, over a leading
  batch axis, on the device of ``theta``;
* ``simulate(generator, n)`` - n joint draws ``theta ~ N(0, I)``, ``y =
  F(theta) + sigma * eps`` on the CPU, from ``generator``;
* ``problem(batch, seed)`` - a step-indexed ``{"theta", "y"}`` data source
  (registered in ``repro_torch.data``) for the supervised loop;
* ``analytic_posterior(y)`` - the exact Gaussian posterior of ``theta | y``
  (every operator here is linear), in float64 numpy: the ground truth the
  calibration suite holds a learned posterior against.

The matrix is an f32 CPU tensor.  ``blur`` and ``seismic`` are
deterministic; ``linear_gaussian`` and ``mask_tomo`` draw from
``torch.Generator``s seeded as the reference seeds its keys (the bits differ
from JAX's), and ``ForwardOperator`` takes any matrix, the reference's
included.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def host64(v) -> np.ndarray:
    """``v`` (a tensor on any device, an array or a list) as float64 numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)


class ForwardOperator:
    """Linear forward operator ``y = theta @ matrix + sigma * eps`` with a
    standard-normal prior on theta; ``matrix`` is (d_theta, d_y)."""

    name: str = "linear"

    def __init__(self, matrix, sigma: float):
        if not isinstance(matrix, torch.Tensor):
            matrix = torch.from_numpy(np.array(matrix))
        self.matrix = matrix.detach().cpu().float()
        self.sigma = float(sigma)

    @property
    def d_theta(self) -> int:
        return self.matrix.shape[0]

    @property
    def d_y(self) -> int:
        return self.matrix.shape[1]

    def apply(self, theta: torch.Tensor) -> torch.Tensor:
        """The noise-free forward map, over leading axes."""
        return theta @ self.matrix.to(theta.device, theta.dtype)

    def simulate(self, generator: torch.Generator, n: int):
        """``n`` joint draws on the CPU: ``theta ~ N(0, I)``, then ``y =
        F(theta) + sigma eps``, both from ``generator``, in that order."""
        theta = torch.randn((n, self.d_theta), generator=generator)
        y = self.apply(theta) + self.sigma * torch.randn((n, self.d_y), generator=generator)
        return theta, y

    def problem(self, batch: int = 256, seed: int = 0) -> "OperatorProblem":
        """Step-indexed ``{"theta", "y"}`` data source over this operator."""
        return OperatorProblem(self, batch=batch, seed=seed)

    def analytic_posterior(self, y):
        """The exact posterior ``N(mu, Sigma)`` of ``theta | y`` for one
        observation ``y`` (d_y,), the linear-Gaussian conjugate formula
        (prior N(0, I)): ``Sigma^-1 = I + A A^T / sigma^2``, ``mu = Sigma A y
        / sigma^2``.  Float64 numpy on the host: the small-noise operators
        (seismic's sigma is 0.02) make the precision matrix too
        ill-conditioned for an f32 inversion."""
        a = host64(self.matrix)
        prec = np.eye(self.d_theta) + (a @ a.T) / self.sigma**2
        cov = np.linalg.inv(prec)
        mu = cov @ (a @ host64(y).reshape(-1)) / self.sigma**2
        return mu, cov


class OperatorProblem:
    """A step-indexed data source over a ``ForwardOperator``: ``batch_at``
    is a pure function of ``(seed, step, shard)``, drawn from a generator of
    its own, so a restart that resumes at step k sees the same stream.
    Over ``LinearGaussianOperator`` it is the port's
    ``SyntheticInverseProblem`` of the same seed, batch for batch."""

    def __init__(self, op: ForwardOperator, batch: int = 256, seed: int = 0):
        self.op = op
        self.batch = batch
        self.seed = seed
        self.d_theta, self.d_y, self.sigma = op.d_theta, op.d_y, op.sigma

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + step * 131 + shard + 7)
        theta, y = self.op.simulate(g, self.batch // n_shards)
        return {"theta": theta, "y": y}

    def posterior(self, y):
        return self.op.analytic_posterior(y)


# ---------------------------------------------------------------------------
# the operator library
# ---------------------------------------------------------------------------


class LinearGaussianOperator(ForwardOperator):
    """A dense random sensing matrix, the fully controlled reference problem:
    the draw of the port's ``SyntheticInverseProblem`` of the same seed."""

    name = "linear_gaussian"

    def __init__(self, d_theta: int = 8, d_y: int = 16, sigma: float = 0.3, seed: int = 0):
        g = torch.Generator().manual_seed(seed + 999)
        super().__init__(torch.randn((d_theta, d_y), generator=g) / math.sqrt(d_theta), sigma)


class BlurOperator(ForwardOperator):
    """Gaussian-blur deconvolution: theta is a 1-D signal, y its same-length
    blur, the canonical ill-posed smoothing operator (a medical-imaging
    stand-in).  ``width`` is the blur kernel's standard deviation in
    samples."""

    name = "blur"

    def __init__(self, size: int = 16, width: float = 1.5, sigma: float = 0.05):
        idx = torch.arange(size, dtype=torch.float32)
        # Toeplitz convolution matrix of a truncated, renormalised Gaussian
        # kernel: y[j] is a unit-weight average of theta around j
        k = torch.exp(-0.5 * ((idx[:, None] - idx[None, :]) / width) ** 2)
        super().__init__(k / torch.sum(k, dim=0, keepdim=True), sigma)
        self.width = float(width)


def mask_matrix(mask: torch.Tensor) -> torch.Tensor:
    """The tomography matrix of a boolean (d_theta, n_meas) ``mask``: each
    column lit on at least one entry (a dead column is re-lit on the
    deterministic diagonal ``i == j % d_theta``, so the operator stays
    full-noise-rank), then divided by its count, so each measurement
    averages the entries it sees."""
    d_theta, n_meas = mask.shape
    dead = ~mask.any(dim=0)
    diag = torch.arange(d_theta)[:, None] == torch.arange(n_meas)[None, :] % d_theta
    mask = mask | (dead[None, :] & diag)
    return mask.float() / mask.sum(dim=0).float()[None, :]


class MaskTomographyOperator(ForwardOperator):
    """Randomized-mask "tomography": each of ``n_meas`` measurements averages
    a random subset of the parameter entries (a binary mask row), a compact
    stand-in for sparse-view projection data.  ``keep`` is the per-entry
    inclusion probability."""

    name = "mask_tomo"

    def __init__(self, d_theta: int = 16, n_meas: int = 24, keep: float = 0.4,
                 sigma: float = 0.1, seed: int = 0):
        g = torch.Generator().manual_seed(seed + 4242)
        super().__init__(mask_matrix(torch.rand((d_theta, n_meas), generator=g) < keep), sigma)
        self.keep = float(keep)


class SeismicConvOperator(ForwardOperator):
    """Seismic-style band-limited convolution: theta is a reflectivity trace,
    y the trace convolved with a Ricker wavelet of dominant (normalised)
    frequency ``f0``, the textbook post-stack seismic forward model.
    Band-limitation removes the low and high frequencies, so the posterior's
    uncertainty is anisotropic."""

    name = "seismic"

    def __init__(self, size: int = 32, f0: float = 0.15, sigma: float = 0.02):
        t = torch.arange(-size // 2, size - size // 2, dtype=torch.float32)
        arg = (math.pi * f0 * t) ** 2
        wavelet = (1.0 - 2.0 * arg) * torch.exp(-arg)  # Ricker (Mexican hat)
        wavelet = wavelet / torch.max(torch.abs(wavelet))
        idx = torch.arange(size)
        # same-size Toeplitz convolution: y[j] = sum_i w[j - i] theta[i]
        shift = idx[None, :] - idx[:, None] + size // 2
        valid = (shift >= 0) & (shift < size)
        super().__init__(torch.where(valid, wavelet[shift.clamp(0, size - 1)], 0.0), sigma)
        self.f0 = float(f0)


OPERATORS = {
    cls.name: cls
    for cls in (LinearGaussianOperator, BlurOperator, MaskTomographyOperator,
                SeismicConvOperator)
}


def make_operator(name: str, **kw) -> ForwardOperator:
    """A registered operator by name (see ``OPERATORS``)."""
    try:
        cls = OPERATORS[name]
    except KeyError:
        raise KeyError(f"unknown operator {name!r}; registered: {sorted(OPERATORS)}") from None
    return cls(**kw)
