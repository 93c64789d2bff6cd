"""Build models from registered architectures and make their inputs, the
port of the reference's ``models/registry.py``: ``build_model``,
``input_specs`` (the inputs of one cell as meta tensors, shapes and dtypes
without storage, the counterpart of the reference's ``ShapeDtypeStruct``
stand-ins) and ``batch_like`` (a concrete batch drawn from a seeded
generator).  ``SpecBatches`` serves ``batch_like`` batches to ``train_lm``
by step."""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ShapeSpec, get_arch
from repro_torch.models.frontends import VISION_EMBED_DIM
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


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The inputs of the step ``shape.kind`` names, as meta tensors:

    * train - ``tokens`` and ``labels`` (B, S_text) int32, and the modality
      features: ``patches`` (B, n_patches, 1024) for a vision model, whose
      patches take ``n_patches`` of the S positions, ``frames`` (B,
      n_frames, d_model) for an encoder-decoder, in the activation dtype;
    * prefill - the same without labels;
    * decode - one new token per sequence (the caches come from
      ``Model.make_caches``)."""
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)

    def spec(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((b, 1), torch.int32)}
    specs = {}
    s_text = s
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        s_text = s - cfg.frontend.n_patches
        if s_text < 1:
            raise ValueError(f"{cfg.name}: {s} positions leave no text after "
                             f"{cfg.frontend.n_patches} patches")
        specs["patches"] = spec((b, cfg.frontend.n_patches, VISION_EMBED_DIM), act)
    if cfg.is_enc_dec:
        specs["frames"] = spec((b, cfg.frontend.n_frames, cfg.d_model), act)
    specs["tokens"] = spec((b, s_text), torch.int32)
    if shape.kind == "train":
        specs["labels"] = spec((b, s_text), torch.int32)
    return specs


def batch_like(specs: dict, generator: torch.Generator, vocab_size: int) -> dict:
    """A concrete batch matching ``specs``, drawn in their order on the
    generator's device: integer inputs uniform in ``[0, vocab_size)``,
    floating ones standard normal in their dtype."""
    dev = generator.device
    out = {}
    for key, v in specs.items():
        if v.is_floating_point():
            out[key] = torch.randn(v.shape, generator=generator, device=dev).to(v.dtype)
        else:
            out[key] = torch.randint(0, vocab_size, v.shape, generator=generator, device=dev,
                                     dtype=v.dtype)
    return out


class SpecBatches:
    """``batch_at(step)``: the ``batch_like`` batch of ``input_specs(cfg,
    shape)`` from a CPU generator seeded ``(seed, step)``, a pure function of
    the step, as ``train_lm``'s sources are."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0):
        self.specs, self.vocab_size, self.seed = input_specs(cfg, shape), cfg.vocab_size, seed

    def batch_at(self, step: int) -> dict:
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        return batch_like(self.specs, gen, self.vocab_size)
