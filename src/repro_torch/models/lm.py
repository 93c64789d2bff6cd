"""The language model served from its caches, the port of the reference's
``models/lm.py::Model`` for the text-only decoder: the dense, ``ssm``
(rwkv6) and ``hybrid`` (zamba2) families.

``Model`` is a module whose parameters follow the reference's tree, so
``state_dict()`` keys read like its paths (``blocks.attn.attn.wq``,
``blocks.time_mix.rwkv.mu``, ``tail_blocks.mamba0.mamba.wx``,
``shared_attn.wq``) and ``bridge.params_from_numpy`` carries a reference
tree across.  The stacked blocks keep their leading ``n_super`` axis; a
hybrid model's tail blocks are one unstacked superblock, and its shared
attention and FFN weights reach the units through ``Ctx.extra``.  The
reference scans each stack with ``lax.scan``; here a Python loop walks it,
indexing the parameters and the cache trees (nested: an RWKV unit's cache
is ``{"time": {"shift", "wkv"}}``) by superblock.  Caches are written in
place.

Entry points, run under ``torch.inference_mode``:

* ``prefill(batch, caches)`` — the prompt; returns last-position logits
  (f32) and the filled caches;
* ``decode_step(tokens, caches, pos0)`` — one token per sequence.

``train_loss``, the cacheless stack runner, tied or vision/audio inputs
beyond the text embedding, and the other families wait for their slices
(``ROADMAP.md`` queue 1, item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.types import ParamTree, resolve_device, tree_index
from repro_torch.models.blocks import Ctx, SuperBlock, decoder_layout, tree_map
from repro_torch.nn.attention import attn_init
from repro_torch.nn.mlp import ffn_init
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
        if self.layout.tail is not None:
            params["tail_blocks"] = self.layout.tail.init_one(generator)
        if self.layout.has_shared_attn:
            params["shared_attn"] = attn_init(generator, d, cfg.attention)
            params["shared_ffn"] = ffn_init(generator, d, cfg.d_ff, cfg.ffn_kind)
        return params

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def make_caches(self, batch: int, max_len: int) -> dict:
        caches = {"blocks": self.layout.main.make_caches(batch, max_len, self.device)}
        if self.layout.tail is not None:
            caches["tail"] = self.layout.tail.make_caches(batch, max_len, self.device)
        return caches

    def _stack_cache(self, sb: SuperBlock, params_at, caches, h, pos0: int, extra):
        """Run one stack with its caches (prefill / decode), writing them in
        place; ``params_at(i)`` is superblock i's parameters.  Returns the
        stack's output in the activation dtype."""
        cfg = self.cfg
        ctx = Ctx(torch.arange(pos0, pos0 + h.shape[1], device=h.device), pos0, extra)
        if cfg.reversible:
            rdt = getattr(torch, cfg.residual_dtype)
            state = (h.to(rdt), h.to(rdt))
        else:
            state = h.to(getattr(torch, cfg.dtype))
        step = sb.fwd_pair if cfg.reversible else sb.fwd_std
        for i in range(sb.n_super):
            state = step(params_at(i), state, tree_map(lambda v: v[i], caches), ctx)
        if cfg.reversible:
            x1, x2 = state
            return ((x1 + x2) * 0.5).to(getattr(torch, cfg.dtype))
        return state

    def _embed(self, tokens):
        return F.embedding(tokens.long(), self.embed).to(getattr(torch, self.cfg.dtype))

    def _extra(self):
        """The shared inputs of the units: a hybrid model's shared attention
        and FFN weights, as the ``ParamTree`` modules that hold them (indexed
        by key like the dicts of the main stack)."""
        if not self.layout.has_shared_attn:
            return None
        return {"shared_attn": self.shared_attn, "shared_ffn": self.shared_ffn}

    def _assemble(self, batch):
        """The text-only input: the embedded tokens and the shared inputs."""
        if self.cfg.frontend is not None or self.cfg.is_enc_dec:
            raise NotImplementedError("vision and audio front ends are not ported yet "
                                      "(ROADMAP.md queue 1, item 6)")
        return self._embed(batch["tokens"]), self._extra()

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _decode_core(self, h, caches, pos0: int, extra):
        h = self._stack_cache(self.layout.main, lambda i: tree_index(self.blocks, i),
                              caches["blocks"], h, pos0, extra)
        if self.layout.tail is not None:
            # the tail is a second stack: h splits into two streams again
            h = self._stack_cache(self.layout.tail, lambda i: self.tail_blocks, caches["tail"], h,
                                  pos0, extra)
        return rmsnorm(h, self.final_norm, self.cfg.norm_eps), caches

    def _logits(self, h):
        return (h[:, -1] @ self._head().to(h.dtype)).float()

    @torch.inference_mode()
    def prefill(self, batch: dict, caches: dict):
        """The whole prompt ``batch["tokens"]`` (B, S); returns (last-position
        logits (B, vocab) f32, caches)."""
        h, extra = self._assemble(batch)
        h, caches = self._decode_core(h, caches, 0, extra)
        return self._logits(h), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches: dict, pos0: int):
        """One decode step.  tokens: (B, 1); pos0: the write position."""
        h, caches = self._decode_core(self._embed(tokens), caches, pos0, self._extra())
        return self._logits(h), caches
