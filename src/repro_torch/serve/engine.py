"""Serving engines, the port of the reference's ``serve/engine.py``:
``ServeEngine`` (an LM's prefill, then cached greedy or temperature decode
steps, with a vision model's patches or an encoder-decoder's frames) and
``FlowServeEngine`` (batched ``log_prob`` and ``sample`` of a normalizing
flow, batch-sharded over a mesh's data axes: each rank runs its rows and
every rank gets the whole batch back).  An LM on a mesh stores its
parameters by the reference's ``params_pspecs`` (``dist/model.py``: each
rank its blocks, gathered where a request uses them), its caches by
``cache_pspecs`` (the batch axis over the data axes) and runs its rows of
the batch.  Requests run under ``torch.inference_mode``; the reference jits
prefill and decode, the port runs them eagerly.

The reference's serving fix (``servefix``) is two options of
``ServeEngine``: ``serve_bf16`` casts the model's f32 weights to bf16, as the
reference's dry run casts its serving parameter specs, and
``cache_seq_fallback`` lays the caches out by ``cache_pspecs(
seq_fallback_model=True)``: a leaf of four or more axes splits its axis 2
over the ``model`` axis too.  For an attention cache that axis is its
positions, and attention attends over the ranks' blocks
(``nn/attention.py::position_split_caches``); any other leaf the rule
splits (an SSM state, by its heads: the rule works by shape) is gathered
whole where its mixer uses it and its block written back after
(:class:`CacheLayout`).
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch

from repro_torch.core.distributions import derive_key, std_normal_logpdf, std_normal_sample
from repro_torch.core.types import resolve_device, to_device
from repro_torch.dist import comm
from repro_torch.dist.flow import gather_batch, shard_batch
from repro_torch.dist.model import ModelSharding
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    cache_pspecs,
    data_axis_names,
    data_size,
    gather_shard,
    local_shard,
    model_size,
)
from repro_torch.nn.attention import position_split_caches


def _local_caches(whole, specs, mesh, device):
    """Zero caches of this rank's block of each (meta) leaf of ``whole``."""
    if isinstance(whole, Mapping):
        return {k: _local_caches(v, specs[k], mesh, device) for k, v in whole.items()}
    return torch.zeros(local_shard(whole, specs, mesh).shape, dtype=whole.dtype, device=device)


def _is_kv(cache) -> bool:
    return isinstance(cache, Mapping) and set(cache) == {"k", "v"}


class CacheLayout:
    """The caches split by ``cache_pspecs(seq_fallback_model=True)``, as a
    ``Model.cache_layout``: a superblock's cache is handed to its units with
    every leaf that splits over ``model`` gathered whole, except attention
    caches, which attention reads by position blocks; after the units ran,
    this rank's block of each gathered leaf is written back."""

    def __init__(self, specs: dict, mesh):
        # the per-superblock specs: each stacked leaf's spec without its
        # leading stack axis
        self.specs = {key: _drop_lead(sub) for key, sub in specs.items()}
        self.mesh = mesh

    def _walk(self, cache, spec, fn):
        if _is_kv(cache):
            return cache
        if isinstance(cache, Mapping):
            return {k: self._walk(v, spec[k], fn) for k, v in cache.items()}
        return fn(cache, spec) if MODEL_AXIS in spec else cache

    def take(self, key: str, cache):
        return self._walk(cache, self.specs[key], lambda v, sp: gather_shard(v, sp, self.mesh))

    def put(self, key: str, cache, taken):
        def write(block, whole, spec):
            if _is_kv(block):
                return
            if isinstance(block, Mapping):
                for k in block:
                    write(block[k], whole[k], spec[k])
            elif MODEL_AXIS in spec:
                block.copy_(local_shard(whole, spec, self.mesh))

        write(cache, taken, self.specs[key])


def _drop_lead(specs):
    if isinstance(specs, Mapping):
        return {k: _drop_lead(v) for k, v in specs.items()}
    return tuple(specs[1:])


class ServeEngine:
    """Serve ``model`` (``models.lm.Model``) on ``device`` (``cuda`` unless
    named; raises without a card) with caches of ``max_len`` positions.
    ``temperature`` 0 decodes greedily.

    ``mesh`` (one process per rank, each calling with the whole batch): on
    a ``model`` axis m > 1 every parameter is stored as this rank's block
    (``params_pspecs``); a request gathers the stacked blocks one
    superblock at a time where the stack takes them, and the other split
    leaves whole for the request.  The caches are laid out by
    ``cache_pspecs`` (batch axis over the data axes) and each rank runs its
    rows of the batch; the ranks of one ``model`` row compute the same
    tokens, and the tokens and the last logits are gathered over the data
    axes, so every rank returns the whole batch.  A model with
    ``attn_seq_shard`` splits its attention over the ``model`` axis, and an
    MoE its experts (``nn/attention.py``, ``nn/moe.py``).

    ``serve_bf16`` casts the model's f32 weights to bf16 (in place) and
    ``cache_seq_fallback`` splits the caches' positions over the ``model``
    axis (the module docstring).  :meth:`prefill` and :meth:`decode` are one
    request step each on the rank's rows and caches (:meth:`caches`), as
    ``generate`` runs them and ``launch/dryrun.py`` reckons them."""

    def __init__(self, model, max_len: int, temperature: float = 0.0, device=None, mesh=None,
                 cache_seq_fallback: bool = False, serve_bf16: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if serve_bf16:
            for p in self.model.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(torch.bfloat16)
        self.max_len = max_len
        self.temperature = temperature
        self.mesh = mesh
        self.cache_seq_fallback = cache_seq_fallback
        self.sharding = (ModelSharding(self.model, mesh).shard()
                         if model_size(mesh) > 1 else None)

    def _sample(self, logits, generator):
        if self.temperature == 0.0:
            return logits.argmax(dim=-1).to(torch.int32)  # the first maximum, as jnp.argmax
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).squeeze(-1).to(torch.int32)

    def generate(self, batch: dict, max_new: int, generator: torch.Generator | None = None,
                 eos_id: int | None = None):
        """batch: ``{"tokens": (B, S)}`` prompt ids, with the model's
        modality features (``"patches"`` for a vision model, whose n_patches
        positions come before the text; ``"frames"`` for an encoder-decoder,
        whose encoder output is computed once and handed to the prefill and
        to every decode step).  Returns (generated tokens (B, n) int32, n <=
        max_new, and the last step's logits).  After ``eos_id`` a sequence
        keeps emitting ``eos_id``; decoding stops when every sequence has.
        ``generator`` (on the engine's device; seed 0 by default) feeds
        temperature sampling (on a mesh, each rank's draws for its rows)."""
        gen = generator if generator is not None else torch.Generator(self.device).manual_seed(0)
        cfg, mesh = self.model.cfg, self.mesh
        with self.request():
            batch = {k: to_device(v, self.device) for k, v in batch.items()}
            full = batch["tokens"].shape[0]
            batch = shard_batch(batch, mesh)
            bsz, prompt_len = batch["tokens"].shape
            caches = self.caches(full)
            extra = {"enc": self.model.encode(batch["frames"])} if cfg.is_enc_dec else None
            logits, caches = self.model.prefill(batch, caches, extra)
            n_prefix = (cfg.frontend.n_patches
                        if cfg.frontend is not None and cfg.frontend.kind == "vision" else 0)
            pos = prompt_len + n_prefix
            out_tokens = []
            done = torch.zeros(bsz, dtype=torch.bool, device=self.device)
            for i in range(max_new):
                tok = self._sample(logits, gen)
                if eos_id is not None:
                    done = done | (tok == eos_id)
                    tok = torch.where(done, eos_id, tok)
                out_tokens.append(tok)
                if eos_id is not None and self._all_done(done):
                    break
                logits, caches = self.model.decode_step(tok[:, None], caches, pos + i, extra)
            toks = torch.stack(out_tokens, dim=1)
            return gather_batch(toks, mesh, full), gather_batch(logits, mesh, full)

    def cache_specs(self, full: int) -> dict:
        """The caches' specs for a batch of ``full`` sequences."""
        whole = self.model.make_caches(full, self.max_len, device="meta")
        return cache_pspecs(whole, self.mesh, seq_fallback_model=self.cache_seq_fallback)

    def caches(self, full: int) -> dict:
        """The caches for a batch of ``full`` sequences: whole without a
        mesh, else this rank's blocks by ``cache_pspecs``."""
        if self.mesh is None:
            return self.model.make_caches(full, self.max_len)
        whole = self.model.make_caches(full, self.max_len, device="meta")
        return _local_caches(whole, self.cache_specs(full), self.mesh, self.device)

    def _positions_split(self) -> bool:
        """The caches' positions split over the ``model`` axis (the rule
        splits a cache's axis 2 when it divides)."""
        return (self.cache_seq_fallback and model_size(self.mesh) > 1
                and self.max_len % model_size(self.mesh) == 0)

    @contextlib.contextmanager
    def request(self):
        """A request's context: inference mode, the mesh bound, the split
        leaves outside the scan stacks whole, the caches' layout."""
        mesh = self.mesh
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(comm.bound(mesh))
            if self.sharding is not None:
                # before inference mode: a meta parameter's data cannot be
                # set to an inference tensor
                stack.enter_context(self.sharding.materialized())
            stack.enter_context(torch.inference_mode())
            if self._positions_split():
                stack.enter_context(position_split_caches(mesh))
                self.model.cache_layout = CacheLayout(self.cache_specs(1), mesh)
                stack.callback(setattr, self.model, "cache_layout", None)
            yield

    def prefill(self, batch: dict, caches: dict):
        """One prefill of this rank's rows ``batch`` into ``caches``:
        (last logits, caches)."""
        with self.request():
            extra = ({"enc": self.model.encode(batch["frames"])} if self.model.cfg.is_enc_dec
                     else None)
            return self.model.prefill(batch, caches, extra)

    def decode(self, tokens, caches: dict, pos0: int, extra: dict | None = None):
        """One decode step of this rank's rows ``tokens`` (B, 1) at
        position ``pos0``: (logits, caches)."""
        with self.request():
            return self.model.decode_step(tokens, caches, pos0, extra)

    def _all_done(self, done: torch.Tensor) -> bool:
        """Every sequence of the whole batch has emitted ``eos_id`` (the
        data ranks agree, so they stop at the same step)."""
        left = (~done).any().to(torch.int32).reshape(1)
        if self.mesh is not None and data_axis_names(self.mesh) and data_size(self.mesh) > 1:
            comm.all_reduce(left, comm.mesh_group(self.mesh, data_axis_names(self.mesh)),
                            op="max")
        return not bool(left.item())


class FlowServeEngine:
    """Serve ``flow`` (an ``Invertible`` module) on ``device`` (``cuda``
    unless named; raises without a card).

    ``sample_flow``: an optional twin that ``sample`` inverts in place of
    ``flow``, as in the reference: a second build of the same network with
    other kernel options (``build_glow(..., kernel_inverse=True)``) that
    holds ``flow``'s own parameters, made with
    ``core.types.share_parameters(twin, flow)``.  One parameter set, two
    builds: whatever trains or moves ``flow`` is seen by the twin.  Without
    it, ``flow`` serves both calls.

    ``mesh``: a data-parallel mesh (one process per rank, each calling with
    the whole batch): each rank runs its rows of the batch and the outputs
    are gathered, so every rank returns the whole batch.  Flows are
    pointwise in the batch, so no other collective is needed."""

    # the sampling stream's tag, as in the reference
    _TAG_SAMPLE = 0

    def __init__(self, flow, device=None, sample_flow=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.flow = flow.to(self.device).eval()
        self.sample_flow = self.flow if sample_flow is None else sample_flow.to(self.device).eval()

    def log_prob(self, x, cond=None) -> torch.Tensor:
        """Per-example log density ``log N(z; 0, I) + logdet`` of a batch."""
        with torch.inference_mode():
            full = x.shape[0]
            x, cond = shard_batch((to_device(x, self.device), to_device(cond, self.device)),
                                  self.mesh)
            z, logdet = self.flow(x, cond)
            return gather_batch(std_normal_logpdf(z) + logdet, self.mesh, full)

    def sample(self, generator: torch.Generator, like, cond=None):
        """Draws shaped like the latent prototype ``like`` (a tensor or the
        tuple state of a multiscale flow; only shapes and dtypes are read).
        The noise comes from the stream ``derive_key(generator, tag)`` on the
        engine's device, drawn at the whole batch's extent before a rank
        takes its rows: the same generator seed gives the same draws on any
        mesh."""
        gen = derive_key(generator, self._TAG_SAMPLE, device=self.device)
        with torch.inference_mode():
            z = std_normal_sample(gen, like)
            full = (z[0] if isinstance(z, tuple) else z).shape[0]
            z, cond = shard_batch((z, to_device(cond, self.device)), self.mesh)
            return gather_batch(self.sample_flow.inverse(z, cond), self.mesh, full)
