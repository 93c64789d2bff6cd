"""Build models from registered architectures, the port of the reference's
``models/registry.py::build_model``."""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, get_arch
from repro_torch.models.lm import Model


def build_model(arch: str | ModelConfig, generator: torch.Generator | None = None, device=None,
                **overrides) -> tuple[Model, ModelConfig]:
    """``(Model, cfg)`` for ``arch`` (a registered name or a config), with
    ``overrides`` applied to the config, on ``device`` (``cuda`` unless
    named; raises without a card)."""
    cfg = arch if isinstance(arch, ModelConfig) else get_arch(arch).config
    if overrides:
        cfg = cfg.replace(**overrides)
    return Model(cfg, generator=generator, device=device), cfg
