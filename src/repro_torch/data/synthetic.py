"""Deterministic, step-indexed synthetic data (``repro/data/synthetic.py``).

A pipeline is a pure function of ``(seed, step)``: each batch comes from its
own ``torch.Generator`` seeded from the pair, so a run that resumes at step
``k`` sees the same stream.  The draws are not JAX's bits; parity tests feed
both packages the same numpy batches instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
