"""Deterministic, step-indexed synthetic data (``repro/data/synthetic.py``).

A pipeline is a pure function of ``(seed, step)``: each batch comes from its
own ``torch.Generator`` seeded from the pair, so a run that resumes at step
``k`` sees the same stream.  The draws are not JAX's bits; parity tests feed
both packages the same numpy batches instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class SyntheticTokens:
    """Token stream with learnable structure (a noisy affine next-token
    rule), so training visibly brings the loss below log(V).  Each row starts
    at a random token and steps by ``7 + start % 5`` mod V; each token is
    replaced by a random one with probability ``noise``.  ``batch_at(step)``
    is ``{"tokens", "labels"}`` (B, S) int32 on the CPU, labels the tokens
    shifted by one, from the generator of ``(seed, step, shard)``."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 noise: float = 0.05):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.noise = noise

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        b = self.batch // n_shards
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + step * 131 + shard)
        start = torch.randint(0, self.vocab, (b, 1), generator=g)
        steps = torch.arange(self.seq_len + 1)
        seq = (start + 7 * steps[None, :] + (start % 5) * steps[None, :]) % self.vocab
        flip = torch.rand(seq.shape, generator=g) < self.noise
        rand = torch.randint(0, self.vocab, seq.shape, generator=g)
        seq = torch.where(flip, rand, seq).to(torch.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class SyntheticImages:
    """Smooth low-frequency images in [0, 1), dequantized: GLOW training
    data, (batch, size, size, channels) float32 on the CPU."""

    def __init__(self, size: int, channels: int = 3, batch: int = 8, seed: int = 0):
        self.size = size
        self.channels = channels
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + step * 131)
        coarse = torch.randn((self.batch, self.channels, 4, 4), generator=g)
        img = F.interpolate(coarse, size=(self.size, self.size), mode="bicubic",
                            align_corners=False)
        img = torch.sigmoid(1.5 * img).permute(0, 2, 3, 1)
        deq = torch.rand(img.shape, generator=g) / 256
        return (img * 255 / 256 + deq).float().contiguous()


class SyntheticInverseProblem:
    """Linear-Gaussian inverse problem with a known posterior:
    ``theta ~ N(0, I)``, ``y = theta A + sigma eps``, A (d_theta, d_y) drawn
    once from the seed.  ``batch_at(step)`` is ``{"theta", "y"}`` float32 on
    the CPU from the step's own generator; the learned posterior can be held
    against :meth:`posterior`."""

    def __init__(self, d_theta: int = 8, d_y: int = 16, sigma: float = 0.3, batch: int = 256,
                 seed: int = 0):
        self.d_theta, self.d_y, self.sigma, self.batch = d_theta, d_y, sigma, batch
        self.seed = seed
        g = torch.Generator().manual_seed(seed + 999)
        self.a_mat = torch.randn((d_theta, d_y), generator=g) / math.sqrt(d_theta)

    def batch_at(self, step: int) -> dict:
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + step * 131 + 7)
        theta = torch.randn((self.batch, self.d_theta), generator=g)
        y = theta @ self.a_mat + self.sigma * torch.randn((self.batch, self.d_y), generator=g)
        return {"theta": theta, "y": y}

    def posterior(self, y):
        """The analytic posterior N(mu, Sigma) of theta for one observation
        y (d_y,), in float64: ``Sigma^-1 = I + A A^T / sigma^2``,
        ``mu = Sigma A y / sigma^2``."""
        a = self.a_mat.double()
        prec = torch.eye(self.d_theta, dtype=torch.float64) + (a @ a.T) / self.sigma**2
        cov = torch.linalg.inv(prec)
        mu = cov @ (a @ torch.as_tensor(y).double().reshape(-1).cpu()) / self.sigma**2
        return mu, cov
