"""The language model served from its KV caches, the port of the reference's
``models/lm.py::Model`` for the text-only decoder.

``Model`` is a module whose parameters follow the reference's tree, so
``state_dict()`` keys read like its paths (``blocks.attn.attn.wq``) and
``bridge.params_from_numpy`` carries a reference tree across.  The stacked
blocks keep their leading ``n_layers`` axis.  The reference scans the stack
with ``lax.scan``; here a Python loop walks it, indexing the parameters and
the caches by layer.  Caches are written in place (``nn/attention.py``).

Entry points, run under ``torch.inference_mode``:

* ``prefill(batch, caches)`` — the prompt; returns last-position logits
  (f32) and the filled caches;
* ``decode_step(tokens, caches, pos0)`` — one token per sequence.

``train_loss``, the cacheless stack runner, tied or vision/audio inputs
beyond the text embedding, and the other families wait for their slices
(``ROADMAP.md`` queue 1, item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.types import ParamTree, resolve_device, tree_index
from repro_torch.models.blocks import Ctx, decoder_layout
from repro_torch.nn.norm import rmsnorm


class Model(ParamTree):
    """``cfg``'s decoder with parameters drawn from ``generator`` (on its
    device; a generator seeded 0 on ``device`` by default), held on
    ``device`` (``cuda`` unless named; raises without a card)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        dev = resolve_device(device)
        # plain attributes may be set before Module.__init__; init() reads them
        self.cfg, self.layout = cfg, decoder_layout(cfg)
        gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        super().__init__(self.init(gen))
        self.to(dev)

    def init(self, generator: torch.Generator) -> dict:
        """The reference's ``Model.init``: a fresh parameter tree, f32, drawn
        on the generator's device."""
        cfg, d, dev = self.cfg, self.cfg.d_model, generator.device
        params = {
            "embed": d**-0.5 * torch.randn((cfg.vocab_size, d), generator=generator, device=dev),
            "blocks": self.layout.main.init_stacked(generator),
            "final_norm": torch.ones(d, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = d**-0.5 * torch.randn((d, cfg.vocab_size), generator=generator,
                                                      device=dev)
        return params

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def make_caches(self, batch: int, max_len: int) -> dict:
        return {"blocks": self.layout.main.make_caches(batch, max_len, self.device)}

    def _stack_cache(self, caches, h, pos0: int, seq_len: int):
        """Run the stack with its caches (prefill / decode), writing them in
        place; returns the stack's output in the activation dtype."""
        cfg, sb = self.cfg, self.layout.main
        ctx = Ctx(torch.arange(pos0, pos0 + seq_len, device=h.device), pos0)
        if cfg.reversible:
            rdt = getattr(torch, cfg.residual_dtype)
            state = (h.to(rdt), h.to(rdt))
        else:
            state = h.to(getattr(torch, cfg.dtype))
        step = sb.fwd_pair if cfg.reversible else sb.fwd_std
        for i in range(sb.n_super):
            cache_i = {name: {k: v[i] for k, v in c.items()} for name, c in caches.items()}
            state = step(tree_index(self.blocks, i), state, cache_i, ctx)
        if cfg.reversible:
            x1, x2 = state
            return ((x1 + x2) * 0.5).to(getattr(torch, cfg.dtype))
        return state

    def _embed(self, tokens):
        return F.embedding(tokens.long(), self.embed).to(getattr(torch, self.cfg.dtype))

    def _assemble(self, batch):
        """The text-only input: the embedded tokens."""
        if self.cfg.frontend is not None or self.cfg.is_enc_dec:
            raise NotImplementedError("vision and audio front ends are not ported yet "
                                      "(ROADMAP.md queue 1, item 12)")
        return self._embed(batch["tokens"])

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _decode_core(self, h, caches, pos0: int):
        h = self._stack_cache(caches["blocks"], h, pos0, h.shape[1])
        return rmsnorm(h, self.final_norm, self.cfg.norm_eps), caches

    def _logits(self, h):
        return (h[:, -1] @ self._head().to(h.dtype)).float()

    @torch.inference_mode()
    def prefill(self, batch: dict, caches: dict):
        """The whole prompt ``batch["tokens"]`` (B, S); returns (last-position
        logits (B, vocab) f32, caches)."""
        h, caches = self._decode_core(self._assemble(batch), caches, 0)
        return self._logits(h), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches: dict, pos0: int):
        """One decode step.  tokens: (B, 1); pos0: the write position."""
        h, caches = self._decode_core(self._embed(tokens), caches, pos0)
        return self._logits(h), caches
