"""Stub modality front ends, the port of the reference's
``models/frontends.py``: the transformer backbone is the deliverable, and
``models/registry.py::input_specs`` names precomputed frame or patch
embeddings.

The stubs are small learned adapters (a projection, then RMSNorm), so their
parameters and gradients are real although the conv / ViT towers are not
reproduced.  They sit outside the invertible stack, as the paper's
non-invertible summary networks do.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.nn.norm import rmsnorm

VISION_EMBED_DIM = 1024  # CLIP-ViT-like patch feature dim (stub input)


def frontend_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``{"proj", "norm"}`` for ``cfg.frontend``, f32, drawn on the
    generator's device; ``{}`` without a front end.  Vision projects
    ``VISION_EMBED_DIM`` patch features; audio frames arrive at d_model (the
    stubbed conv front end), and a learned adapter stands in for the conv
    stack."""
    f = cfg.frontend
    if f is None:
        return {}
    d, dev = cfg.d_model, generator.device
    if f.kind == "vision":
        d_in = VISION_EMBED_DIM
    elif f.kind == "audio":
        d_in = d
    else:
        raise ValueError(f"unknown frontend {f.kind}")
    return {"proj": d_in**-0.5 * torch.randn((d_in, d), generator=generator, device=dev),
            "norm": torch.ones(d, device=dev)}


def frontend_apply(params, feats: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """feats: (B, N, d_feat) precomputed embeddings -> (B, N, d_model) in
    the activation dtype.  The reference's rounding: ``feats`` and ``proj``
    cast to the activation dtype, multiplied, then ``rmsnorm``."""
    dtype = getattr(torch, cfg.dtype)
    h = feats.to(dtype) @ params["proj"].to(dtype)
    return rmsnorm(h, params["norm"], cfg.norm_eps)
