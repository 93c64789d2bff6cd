"""The language model, the port of the reference's ``models/lm.py::Model``
for every family: the text decoders (dense, ``moe``, ``ssm`` (rwkv6),
``hybrid`` (zamba2)), the vision-language model (llava-next-34b: projected
patch embeddings before the text) and the encoder-decoder (whisper-small:
an encoder over projected audio frames, read by the decoder's cross
attention), trained and served.

``Model`` is a module whose parameters follow the reference's tree, so
``state_dict()`` keys read like its paths (``blocks.attn.attn.wq``,
``blocks.moe.moe.experts.w_gate``, ``blocks.time_mix.rwkv.mu``,
``tail_blocks.mamba0.mamba.wx``, ``shared_attn.wq``, ``frontend.proj``,
``encoder.attn.attn.wq``, ``enc_norm``) and ``bridge.params_from_numpy``
carries a reference tree across.  The stacked blocks keep their leading
``n_super`` axis; a hybrid model's tail blocks are one unstacked
superblock, and its shared attention and FFN weights reach the units through
``Ctx.extra``, as the encoder output does (``extra["enc"]``).  A tied
model's head is ``embed.T``.  The reference scans each stack with
``lax.scan``; here a Python loop walks it.

Entry points:

* ``train_loss(batch, grad_mode=None)`` - ``(loss, {"xent", "aux"})`` of a
  ``{"tokens", "labels"}`` batch (plus ``"patches"`` (B, n_patches, 1024)
  for a vision model, ``"frames"`` (B, n_frames, d_model) for an
  encoder-decoder); the stacks run through
  ``core/autodiff.py::make_scan_apply`` (``grad_mode`` ``"invertible"`` by
  default when ``cfg.reversible``, the paper's recompute-by-inversion;
  ``"coupled"``, the fused reversible backward; ``"remat"``, per-superblock
  checkpointing and the default of a standard stack; ``"autodiff"``; the
  encoder takes the default engine whatever the decoder's, as in the
  reference, and its output enters the decoder's engine as a shared input
  whose cotangent is summed over the decoder's superblocks), a hybrid
  model's tail by plain autograd, and the loss through the chunked
  cross-entropy (``models/losses.py``) over the text positions; the MoE aux
  enters as ``aux_loss_weight * sum(aux)``;
* ``prefill(batch, caches, extra_inputs=None)`` - the prompt (and its
  modality features); returns last-position logits (f32) and the filled
  caches, under ``torch.inference_mode``; ``extra_inputs={"enc": ...}``
  (``encode``'s) spares the encoder pass;
* ``decode_step(tokens, caches, pos0, extra_inputs=None)`` - one token per
  sequence, the same; an encoder-decoder takes ``{"enc": encode(frames)}``.
  Caches are nested (an RWKV unit's is ``{"time": {"shift", "wkv"}}``),
  indexed by superblock and written in place.

On a model-sharded mesh (``dist/model.py``) the stacks that
:meth:`Model.scan_stacks` names (``blocks``, ``encoder``) give
``tree_index`` one superblock's leaves gathered whole where the stack takes
them, once in the forward and again in the rebuild of the ``invertible`` /
``coupled`` backward (the same bits), and the other split leaves are
gathered whole for the step or the request.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.autodiff import make_scan_apply
from repro_torch.core.types import ParamTree, resolve_device, tree_dict, tree_index
from repro_torch.models.blocks import Ctx, SuperBlock, decoder_layout, encoder_layout, tree_map
from repro_torch.models.frontends import frontend_apply, frontend_init
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.nn.attention import attn_init
from repro_torch.nn.mlp import ffn_init
from repro_torch.nn.norm import rmsnorm


def default_grad_mode(cfg: ModelConfig) -> str:
    """The stack's gradient engine when ``train_loss`` names none:
    ``invertible`` for a reversible stack, else ``remat``."""
    return "invertible" if cfg.reversible else "remat"


class Model(ParamTree):
    """``cfg``'s decoder with parameters drawn from ``generator`` (on its
    device; a generator seeded 0 on ``device`` by default), held on
    ``device`` (``cuda`` unless named; raises without a card)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        dev = resolve_device(device)
        # plain attributes may be set before Module.__init__; init() reads them
        self.cfg, self.layout = cfg, decoder_layout(cfg)
        self.enc_layout = encoder_layout(cfg) if cfg.is_enc_dec else None
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
        if cfg.frontend is not None:
            params["frontend"] = frontend_init(generator, cfg)
        if self.enc_layout is not None:
            params["encoder"] = self.enc_layout.main.init_stacked(generator)
            params["enc_norm"] = torch.ones(d, device=dev)
        return params

    def scan_stacks(self) -> list:
        """The stacks the scan engine walks one superblock at a time."""
        return [self.blocks] + ([self.encoder] if self.enc_layout is not None else [])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def make_caches(self, batch: int, max_len: int, device=None) -> dict:
        """Zero caches on ``device`` (the model's by default; ``"meta"`` for
        their shapes alone)."""
        dev = self.device if device is None else device
        caches = {"blocks": self.layout.main.make_caches(batch, max_len, dev)}
        if self.layout.tail is not None:
            caches["tail"] = self.layout.tail.make_caches(batch, max_len, dev)
        return caches

    #: how the caches are laid out across ranks, set by ``serve/engine.py``
    #: for a request on a mesh whose caches split by position: ``take(key,
    #: cache)`` gives a superblock's cache with every split leaf a mixer
    #: needs whole gathered, ``put(key, cache, taken)`` writes this rank's
    #: blocks back; None: the caches as they are
    cache_layout = None

    def _stack_cache(self, sb: SuperBlock, params_at, caches, h, pos0: int, extra,
                     key: str = "blocks"):
        """Run one stack with its caches (``caches[key]``; prefill / decode),
        writing them in place; ``params_at(i)`` is superblock i's parameters.
        Returns the stack's output in the activation dtype."""
        cfg = self.cfg
        ctx = Ctx(torch.arange(pos0, pos0 + h.shape[1], device=h.device), pos0, extra)
        if cfg.reversible:
            rdt = getattr(torch, cfg.residual_dtype)
            state = (h.to(rdt), h.to(rdt))
        else:
            state = h.to(getattr(torch, cfg.dtype))
        step = sb.fwd_pair if cfg.reversible else sb.fwd_std
        layout = self.cache_layout
        for i in range(sb.n_super):
            cache = tree_map(lambda v: v[i], caches)
            taken = cache if layout is None else layout.take(key, cache)
            state, _aux = step(params_at(i), state, taken, ctx)
            if layout is not None:
                layout.put(key, cache, taken)
        if cfg.reversible:
            x1, x2 = state
            return ((x1 + x2) * 0.5).to(getattr(torch, cfg.dtype))
        return state

    def _embed(self, tokens):
        return F.embedding(tokens.long(), self.embed).to(getattr(torch, self.cfg.dtype))

    def _extra(self):
        """The shared inputs of the units: a hybrid model's shared attention
        and FFN weights, as nested dicts of the parameters themselves."""
        if not self.layout.has_shared_attn:
            return None
        return {"shared_attn": tree_dict(self.shared_attn),
                "shared_ffn": tree_dict(self.shared_ffn)}

    def encode(self, frames):
        """The encoder output ``rmsnorm(encoder(frontend(frames)))`` (B, F,
        d_model) in the activation dtype, the encoder in the default engine:
        what the decoder's cross attention reads as ``extra["enc"]``."""
        cfg = self.cfg
        h = frames.to(self.device)
        if cfg.frontend is not None and cfg.frontend.kind == "audio":
            h = frontend_apply(self.frontend, h, cfg)
        enc, _ = self._stack_nocache(self.enc_layout.main, self.encoder, h, None,
                                     default_grad_mode(cfg))
        return rmsnorm(enc, self.enc_norm, cfg.norm_eps)

    def _assemble(self, batch, extra_inputs=None):
        """``(h, extra, n_prefix)``: the embedded tokens (after the projected
        patches of a vision model, ``n_prefix`` of them), and the shared
        inputs: a hybrid model's shared weights, an encoder-decoder's
        encoder output (``extra_inputs["enc"]``, or the encoder's pass over
        ``batch["frames"]``, in the default engine as in the reference)."""
        cfg = self.cfg
        extra = dict(self._extra() or {})
        h = self._embed(batch["tokens"])
        n_prefix = 0
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            vis = frontend_apply(self.frontend, batch["patches"].to(h.device), cfg)
            h = torch.cat([vis, h], dim=1)
            n_prefix = vis.shape[1]
        if self.enc_layout is not None:
            enc = (extra_inputs or {}).get("enc")
            extra["enc"] = self.encode(batch["frames"]) if enc is None else enc
        return h, extra or None, n_prefix

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _decode_core(self, h, caches, pos0: int, extra):
        h = self._stack_cache(self.layout.main, lambda i: tree_index(self.blocks, i),
                              caches["blocks"], h, pos0, extra)
        if self.layout.tail is not None:
            # the tail is a second stack: h splits into two streams again
            h = self._stack_cache(self.layout.tail, lambda i: self.tail_blocks, caches["tail"], h,
                                  pos0, extra, key="tail")
        return rmsnorm(h, self.final_norm, self.cfg.norm_eps), caches

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _grad_mode(self, override: str | None) -> str:
        return override if override is not None else default_grad_mode(self.cfg)

    def _stack_nocache(self, sb: SuperBlock, stacked, h, extra, grad_mode: str):
        """Run the stack ``sb`` of superblocks (parameters ``stacked``, a
        module) without caches through the scan engine.  Reversible: the
        pair state ``(h, h)`` in the residual dtype, each step ``fwd_pair``,
        inverted by ``inv_pair`` and fused by ``bwd_pair_fused``; standard:
        ``fwd_std`` under ``"autodiff"`` or (any other mode) ``"remat"``.
        ``extra``, the shared inputs, enters as the engine's shared
        ``cond``.  Returns ``(h, aux (B,))``, h in the activation dtype."""
        cfg = self.cfg
        positions = torch.arange(h.shape[1], device=h.device)
        dtype = getattr(torch, cfg.dtype)

        def ctx(ex):
            return Ctx(positions, 0, ex)

        if cfg.reversible:
            def step_fwd(p, state, ex):
                return sb.fwd_pair(p, state, None, ctx(ex))

            def step_inv(p, state, ex):
                return sb.inv_pair(p, state, ctx(ex))

            def step_bwd(i, y, gy, gld, ex):
                return sb.bwd_pair_fused(tree_index(stacked, i, detach=True), y, gy, gld, ctx(ex))

            apply = make_scan_apply(stacked, step_fwd, step_inv, grad_mode, step_bwd=step_bwd)
            rdt = getattr(torch, cfg.residual_dtype)
            (x1, x2), aux = apply((h.to(rdt), h.to(rdt)), extra)
            return ((x1 + x2) * 0.5).to(dtype), aux

        def step_std(p, x, ex):
            return sb.fwd_std(p, x, None, ctx(ex))

        mode = grad_mode if grad_mode in ("autodiff", "remat") else "remat"
        return make_scan_apply(stacked, step_std, None, mode)(h.to(dtype), extra)

    def _run_decoder_nocache(self, h, extra, grad_mode: str):
        """The decoder without caches: the main stack through the scan
        engine, then a hybrid model's tail blocks by plain autograd (a
        constant count, as in the reference)."""
        h, aux = self._stack_nocache(self.layout.main, self.blocks, h, extra, grad_mode)
        if self.layout.tail is not None:
            cfg = self.cfg
            ctx = Ctx(torch.arange(h.shape[1], device=h.device), 0, extra)
            p = tree_dict(self.tail_blocks)
            if cfg.reversible:
                rdt = getattr(torch, cfg.residual_dtype)
                (x1, x2), aux_t = self.layout.tail.fwd_pair(p, (h.to(rdt), h.to(rdt)), None, ctx)
                h = ((x1 + x2) * 0.5).to(getattr(torch, cfg.dtype))
            else:
                h, aux_t = self.layout.tail.fwd_std(p, h, None, ctx)
            aux = aux + aux_t
        return h, aux

    def train_loss(self, batch: dict, grad_mode: str | None = None):
        """``(loss, {"xent", "aux"})`` of ``batch`` (``{"tokens", "labels"}``,
        (B, S) ids, label -1 ignored, and the model's modality features):
        the mean next-token NLL over the text positions plus, for ``moe``,
        ``aux_loss_weight`` times the summed load-balance aux."""
        cfg = self.cfg
        h, extra, n_prefix = self._assemble(batch)
        h, aux = self._run_decoder_nocache(h, extra, self._grad_mode(grad_mode))
        h = rmsnorm(h, self.final_norm, cfg.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        labels = batch["labels"].to(h.device)
        xent = chunked_softmax_xent(h, self._head(), labels)
        aux_total = aux.sum()
        weight = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
        return xent + weight * aux_total, {"xent": xent, "aux": aux_total}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _logits(self, h):
        return (h[:, -1] @ self._head().to(h.dtype)).float()

    @torch.inference_mode()
    def prefill(self, batch: dict, caches: dict, extra_inputs: dict | None = None):
        """The whole prompt ``batch["tokens"]`` (B, S) with its modality
        features; returns (last-position logits (B, vocab) f32, caches).
        ``extra_inputs={"enc": ...}`` gives the encoder output in place of
        the encoder's pass over ``batch["frames"]``."""
        h, extra, _ = self._assemble(batch, extra_inputs)
        h, caches = self._decode_core(h, caches, 0, extra)
        return self._logits(h), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches: dict, pos0: int, extra_inputs: dict | None = None):
        """One decode step.  tokens: (B, 1); pos0: the write position;
        ``extra_inputs``: an encoder-decoder's ``{"enc": encode(frames)}``."""
        extra = {**(self._extra() or {}), **(extra_inputs or {})}
        h, caches = self._decode_core(self._embed(tokens), caches, pos0, extra or None)
        return self._logits(h), caches
