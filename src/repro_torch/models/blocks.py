"""Transformer superblocks, the port of the reference's ``models/blocks.py``
for the dense family.

A superblock is the smallest repeating parameter pattern of a model; for a
dense architecture it is one attention unit and one FFN unit.  In reversible
mode the units alternate over two residual streams (additive coupling):

    x1 += attn(x2);  x2 += ffn(x1)

In standard mode they apply in turn to one stream.  Units return their
residual delta and write their caches in place; they run with caches
(prefill and decode), the only stack runner serving needs.  What waits for
later slices (``ROADMAP.md`` queue 1, item 12): the cacheless runner and the
inverse and fused backward of the coupling that LM training needs, the MoE,
SSM and hybrid units with the per-sample aux channel they feed, shared and
cross attention, and the encoder layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.nn.attention import attn_apply, attn_init, make_cache
from repro_torch.nn.mlp import ffn_apply, ffn_init
from repro_torch.nn.norm import rmsnorm


class Ctx(NamedTuple):
    """Per-call context handed to every unit."""

    positions: torch.Tensor  # (S,) absolute positions of this call's tokens
    pos0: int  # cache write offset


class Unit(NamedTuple):
    name: str
    # generator -> params, drawn on the generator's device
    init: Callable[[torch.Generator], dict]
    # (params, x, cache, ctx) -> delta; the cache is written in place
    apply: Callable[[dict, torch.Tensor, dict, Ctx], torch.Tensor]
    # (batch, max_len, device) -> cache ({} if stateless)
    make_cache: Callable[[int, int, object], dict]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def attention_unit(cfg: ModelConfig, name: str = "attn") -> Unit:
    acfg, d, dtype = cfg.attention, cfg.d_model, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "attn": attn_init(generator, d, acfg)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        out, _ = attn_apply(p["attn"], h, acfg, ctx.positions, cache=cache, cache_pos=ctx.pos0,
                            seq_shard=cfg.attn_seq_shard)
        return out

    def mk_cache(batch, max_len, device):
        return make_cache(acfg, batch, max_len, dtype, device)

    return Unit(name, init, apply, mk_cache)


def ffn_unit(cfg: ModelConfig, name: str = "ffn") -> Unit:
    d, dff, kind, dtype = cfg.d_model, cfg.d_ff, cfg.ffn_kind, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "ffn": ffn_init(generator, d, dff, kind)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        return ffn_apply(p["ffn"], h, kind)

    return Unit(name, init, apply, lambda batch, max_len, device: {})


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_copy_into(dst, src, i):
    for k, v in src.items():
        if isinstance(v, dict):
            _tree_copy_into(dst[k], v, i)
        else:
            dst[k][i] = v


@dataclass(frozen=True)
class SuperBlock:
    units: tuple[Unit, ...]
    n_super: int  # number of stacked superblocks

    def init_one(self, generator) -> dict:
        return {u.name: u.init(generator) for u in self.units}

    def init_stacked(self, generator) -> dict:
        """``n_super`` draws of ``init_one``, each leaf stacked on a leading
        axis; one superblock's draw is held at a time beside the stack."""
        first = self.init_one(generator)
        stacked = _tree_map(lambda v: v.new_empty((self.n_super,) + v.shape), first)
        _tree_copy_into(stacked, first, 0)
        del first
        for i in range(1, self.n_super):
            _tree_copy_into(stacked, self.init_one(generator), i)
        return stacked

    def make_caches(self, batch: int, max_len: int, device=None) -> dict:
        """Each unit's cache with a leading ``n_super`` axis."""
        one = {u.name: u.make_cache(batch, max_len, device) for u in self.units}
        return _tree_map(lambda v: v.new_zeros((self.n_super,) + v.shape), one)

    def fwd_pair(self, p, state, cache, ctx: Ctx):
        """Reversible coupling over ``(x1, x2)``: even units read x2 and add
        into x1, odd units read x1 and add into x2."""
        x1, x2 = state
        for j, u in enumerate(self.units):
            src = x2 if j % 2 == 0 else x1
            delta = u.apply(p[u.name], src, cache.get(u.name, {}), ctx)
            if j % 2 == 0:
                x1 = x1 + delta.to(x1.dtype)
            else:
                x2 = x2 + delta.to(x2.dtype)
        return x1, x2

    def fwd_std(self, p, x, cache, ctx: Ctx):
        """Standard single-stream residual stack."""
        for u in self.units:
            x = x + u.apply(p[u.name], x, cache.get(u.name, {}), ctx).to(x.dtype)
        return x


@dataclass(frozen=True)
class StackLayout:
    main: SuperBlock


def decoder_layout(cfg: ModelConfig) -> StackLayout:
    """Superblock layout of the decoder stack."""
    if cfg.family in ("dense", "vlm"):
        return StackLayout(SuperBlock((attention_unit(cfg), ffn_unit(cfg)), cfg.n_layers))
    raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet "
                              "(ROADMAP.md queue 1, item 12)")
