"""Base densities for normalizing flows."""

from __future__ import annotations

import hashlib
import math

import torch


def _leaves(z) -> list:
    return list(z) if isinstance(z, (tuple, list)) else [z]


def flatten_state(z) -> torch.Tensor:
    """Flatten a latent state (tensor or tuple of tensors) to (B, D), in the
    reference's leaf order."""
    return torch.cat([v.reshape(v.shape[0], -1) for v in _leaves(z)], dim=1)


def std_normal_logpdf(z) -> torch.Tensor:
    """log N(z; 0, I) per sample, over a latent state."""
    flat = flatten_state(z).float()
    d = flat.shape[1]
    return -0.5 * torch.sum(flat**2, dim=1) - 0.5 * d * math.log(2 * math.pi)


def std_normal_sample(generator: torch.Generator, like):
    """Standard-normal draws shaped like ``like`` (a tensor or tuple of
    tensors; only shapes and dtypes are read, so ``like`` may sit on the
    ``meta`` device).  Leaves are drawn in order from ``generator`` on
    the generator's device."""
    dev = generator.device
    out = [
        torch.randn(v.shape, dtype=v.dtype, generator=generator, device=dev)
        for v in _leaves(like)
    ]
    return tuple(out) if isinstance(like, (tuple, list)) else out[0]


def derive_key(generator: torch.Generator, tag: int, device=None) -> torch.Generator:
    """A fresh generator for sampling stream ``tag``, seeded from the
    caller's generator seed.

    The contract of the reference's split-and-fold derivation: the same
    ``(seed, tag)`` always gives the same draws on a device, whatever else
    the caller did with ``generator`` (its state is read, never advanced),
    and distinct tags give separate streams.  The bits differ from JAX's.
    """
    dev = torch.device(device) if device is not None else generator.device
    digest = hashlib.blake2b(
        f"{generator.initial_seed()}:{tag}".encode(), digest_size=8
    ).digest()
    return torch.Generator(device=dev).manual_seed(
        int.from_bytes(digest, "little") & ((1 << 63) - 1)
    )
