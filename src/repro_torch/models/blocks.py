"""Superblocks, the port of the reference's ``models/blocks.py`` for every
family: dense, ``vlm``, ``moe``, ``ssm`` (rwkv6), ``hybrid`` (zamba2) and
``audio`` (the whisper encoder and decoder).

A superblock is the smallest repeating parameter pattern of a model:

* dense archs — 1 block (attention + FFN);
* granite-moe (MoE interleave 1) — 1 block (attention + MoE);
* llama4-maverick (interleave 2) — 2 blocks (attention + FFN, attention +
  MoE) over ``n_layers // 2`` superblocks;
* rwkv6 — 1 block (time-mix + channel-mix);
* zamba2 (hybrid) — k Mamba2 blocks + one application of the *shared*
  attention and FFN (their weights live in ``Ctx.extra``; only each
  application's norms and KV cache are per superblock), then a tail of
  ``n_layers % k`` Mamba2 blocks run as a second stack.
* whisper — the decoder: self attention, cross attention over the encoder
  output (``Ctx.extra["enc"]``, no cache) and the MLP; the encoder
  (``encoder_layout``): non-causal self attention and the MLP.

In reversible mode the units alternate over two residual streams (additive
coupling):

    x1 += u_0(x2);  x2 += u_1(x1);  x1 += u_2(x2);  ...

which is exactly invertible (``inv_pair``), and ``bwd_pair_fused`` rebuilds
each unit's input and differentiates it in one evaluation: the LM stack's
steps in ``core/autodiff.py::make_scan_apply``.  In standard mode the units
apply in turn to one stream.

A unit returns ``(delta, aux)``: its residual delta and its per-sample (B,)
aux (the MoE load-balance loss; None for the others), which the superblock
sums over its units into the scan engine's logdet slot.  With caches
(prefill and decode) a unit writes them in place (attention caches through
``nn/attention.py``; the SSM units ``copy_`` the mixers' new state into the
cache views, in the reference's dtypes: shifts and conv states in the
activation dtype, wkv and ssd states in f32) and serving ignores the aux;
without (training, ``cache=None``) it is a pure function of its inputs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.types import tree_leaves
from repro_torch.nn.attention import attn_apply, attn_init, cross_kv, make_cache
from repro_torch.nn.mlp import ffn_apply, ffn_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norm import rmsnorm
from repro_torch.nn.ssm import (
    RWKV_CHAN_KEYS,
    RWKV_TIME_KEYS,
    mamba2_apply,
    mamba2_init,
    mamba2_state,
    rwkv6_channel_mix,
    rwkv6_init,
    rwkv6_state,
    rwkv6_time_mix,
)


class Ctx(NamedTuple):
    """Per-call context handed to every unit."""

    positions: torch.Tensor  # (S,) absolute positions of this call's tokens
    pos0: int  # cache write offset
    # shared differentiable inputs: the shared attention's and FFN's weights,
    # the encoder output ("enc")
    extra: Optional[dict] = None


class Unit(NamedTuple):
    name: str
    # generator -> params, drawn on the generator's device
    init: Callable[[torch.Generator], dict]
    # (params, x, cache or None, ctx) -> (delta, aux (B,) or None); a cache
    # is written in place
    apply: Callable[[dict, torch.Tensor, Optional[dict], Ctx], tuple]
    # (batch, max_len, device) -> cache ({} if stateless)
    make_cache: Callable[[int, int, object], dict]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def attention_unit(cfg: ModelConfig, name: str = "attn", *, causal: Optional[bool] = None,
                   shared: bool = False, cross: bool = False) -> Unit:
    """Attention with its norm.  ``causal`` overrides the config's;
    ``shared`` reads the weights from ``ctx.extra["shared_attn"]`` and holds
    only the norm; ``cross`` attends over ``ctx.extra["enc"]`` through
    ``cross_kv`` and keeps no cache."""
    acfg, d, dtype = cfg.attention, cfg.d_model, _dtype(cfg.dtype)
    if causal is not None:
        acfg = dataclasses.replace(acfg, causal=causal)

    def init(generator):
        p = {"norm": torch.ones(d, device=generator.device)}
        if not shared:
            p["attn"] = attn_init(generator, d, acfg)
        return p

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        weights = ctx.extra["shared_attn"] if shared else p["attn"]
        if cross:
            kv = cross_kv(weights, ctx.extra["enc"].to(dtype), acfg)
            return attn_apply(weights, h, acfg, ctx.positions, kv_override=kv)[0], None
        out, _ = attn_apply(weights, h, acfg, ctx.positions, cache=cache, cache_pos=ctx.pos0,
                            seq_shard=cfg.attn_seq_shard)
        return out, None

    def mk_cache(batch, max_len, device):
        return {} if cross else make_cache(acfg, batch, max_len, dtype, device)

    return Unit(name, init, apply, mk_cache)


def ffn_unit(cfg: ModelConfig, name: str = "ffn", *, shared: bool = False) -> Unit:
    """The FFN with its norm; ``shared`` reads the weights from
    ``ctx.extra["shared_ffn"]`` and holds only the norm."""
    d, dff, kind, dtype = cfg.d_model, cfg.d_ff, cfg.ffn_kind, _dtype(cfg.dtype)

    def init(generator):
        p = {"norm": torch.ones(d, device=generator.device)}
        if not shared:
            p["ffn"] = ffn_init(generator, d, dff, kind)
        return p

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        return ffn_apply(ctx.extra["shared_ffn"] if shared else p["ffn"], h, kind), None

    return Unit(name, init, apply, lambda batch, max_len, device: {})


def moe_unit(cfg: ModelConfig, name: str = "moe") -> Unit:
    """The routed experts with their norm; the only unit with an aux."""
    d, mcfg, kind, dtype = cfg.d_model, cfg.moe, cfg.ffn_kind, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "moe": moe_init(generator, d, mcfg, kind)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        return moe_apply(p["moe"], h, mcfg, kind)

    return Unit(name, init, apply, lambda batch, max_len, device: {})


def _copy_state(cache: dict, new: dict):
    """Write a mixer's new state into its cache views, leaf by leaf."""
    for key, value in new.items():
        if isinstance(value, dict):
            _copy_state(cache[key], value)
        else:
            cache[key].copy_(value)


def mamba_unit(cfg: ModelConfig, name: str = "mamba") -> Unit:
    d, scfg, dtype = cfg.d_model, cfg.ssm, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "mamba": mamba2_init(generator, d, scfg)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        y, new_state = mamba2_apply(p["mamba"], h, scfg, cache)
        if cache is not None:
            _copy_state(cache, new_state)
        return y, None

    def mk_cache(batch, max_len, device):
        return mamba2_state(scfg, d, batch, dtype, device)

    return Unit(name, init, apply, mk_cache)


def rwkv_time_unit(cfg: ModelConfig) -> Unit:
    d, scfg, dtype = cfg.d_model, cfg.ssm, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "rwkv": rwkv6_init(generator, d, scfg, cfg.d_ff, keys=RWKV_TIME_KEYS)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        state = None if cache is None else cache["time"]
        y, new_state = rwkv6_time_mix(p["rwkv"], h, scfg, state)
        if cache is not None:
            _copy_state(state, new_state)
        return y, None

    def mk_cache(batch, max_len, device):
        return {"time": rwkv6_state(scfg, d, batch, dtype, device)["time"]}

    return Unit("time_mix", init, apply, mk_cache)


def rwkv_channel_unit(cfg: ModelConfig) -> Unit:
    d, scfg, dtype = cfg.d_model, cfg.ssm, _dtype(cfg.dtype)

    def init(generator):
        return {"norm": torch.ones(d, device=generator.device),
                "rwkv": rwkv6_init(generator, d, scfg, cfg.d_ff, keys=RWKV_CHAN_KEYS)}

    def apply(p, x, cache, ctx: Ctx):
        h = rmsnorm(x.to(dtype), p["norm"], cfg.norm_eps)
        state = None if cache is None else cache["chan"]
        y, new_state = rwkv6_channel_mix(p["rwkv"], h, state)
        if cache is not None:
            _copy_state(state, new_state)
        return y, None

    def mk_cache(batch, max_len, device):
        return {"chan": rwkv6_state(scfg, d, batch, dtype, device)["chan"]}

    return Unit("chan_mix", init, apply, mk_cache)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_copy_into(dst, src, i):
    for k, v in src.items():
        if isinstance(v, dict):
            _tree_copy_into(dst[k], v, i)
        else:
            dst[k][i] = v


def _with_leaves(tree: dict, leaves: dict, prefix: str = "") -> dict:
    """``tree``'s nested dicts with each floating leaf replaced by
    ``leaves[dotted name]``."""
    return {k: _with_leaves(v, leaves, f"{prefix}{k}.") if isinstance(v, dict)
            else leaves.get(prefix + k, v) for k, v in tree.items()}


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)


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
        stacked = tree_map(lambda v: v.new_empty((self.n_super,) + v.shape), first)
        _tree_copy_into(stacked, first, 0)
        del first
        for i in range(1, self.n_super):
            _tree_copy_into(stacked, self.init_one(generator), i)
        return stacked

    def make_caches(self, batch: int, max_len: int, device=None) -> dict:
        """Each unit's cache with a leading ``n_super`` axis."""
        one = {u.name: u.make_cache(batch, max_len, device) for u in self.units}
        return tree_map(lambda v: v.new_zeros((self.n_super,) + v.shape), one)

    def fwd_pair(self, p, state, cache, ctx: Ctx):
        """Reversible coupling over ``(x1, x2)``: even units read x2 and add
        into x1, odd units read x1 and add into x2.  ``cache`` None runs
        without caches.  Returns ``((x1, x2), aux)``, aux (B,) f32 summed
        over the units."""
        x1, x2 = state
        aux = _zero_aux(x1)
        for j, u in enumerate(self.units):
            src = x2 if j % 2 == 0 else x1
            delta, a = u.apply(p[u.name], src, None if cache is None else cache.get(u.name, {}),
                               ctx)
            if a is not None:
                aux = aux + a
            if j % 2 == 0:
                x1 = x1 + delta.to(x1.dtype)
            else:
                x2 = x2 + delta.to(x2.dtype)
        return (x1, x2), aux

    def inv_pair(self, p, state, ctx: Ctx):
        """``fwd_pair``'s inverse without caches: the units in reverse, each
        delta subtracted from the stream it was added to."""
        x1, x2 = state
        for j in range(len(self.units) - 1, -1, -1):
            u = self.units[j]
            delta, _ = u.apply(p[u.name], x2 if j % 2 == 0 else x1, None, ctx)
            if j % 2 == 0:
                x1 = x1 - delta.to(x1.dtype)
            else:
                x2 = x2 - delta.to(x2.dtype)
        return x1, x2

    def bwd_pair_fused(self, p, state, gstate, gld, ctx: Ctx):
        """The fused reversible backward of one superblock from its output
        ``state`` and cotangent ``gstate``: one ``torch.autograd.grad`` per
        unit, in reverse, both rebuilds the unit's input stream (by
        subtracting its delta) and gives the gradients of its parameters,
        of its source stream and of the shared ``ctx.extra``.  ``gld`` is
        the cotangent of the aux; a unit without aux gets none.  ``p`` holds
        this superblock's parameters as leaves that require grad.

        Returns ``((x1, x2), (g1, g2), {name: grad}, {extra name: grad} or
        None)``, names dotted as ``named_parameters()``'s."""
        x1, x2 = state
        g1, g2 = gstate
        gparams: dict = {}
        gextra = None
        extra_leaves = {n: v.detach().requires_grad_()
                        for n, v in tree_leaves(ctx.extra or {})}
        ectx = ctx._replace(extra=_with_leaves(ctx.extra, extra_leaves)) if extra_leaves else ctx
        for j in range(len(self.units) - 1, -1, -1):
            u = self.units[j]
            leaves = tree_leaves(p[u.name], f"{u.name}.")
            with torch.enable_grad():
                src = (x2 if j % 2 == 0 else x1).detach().requires_grad_()
                delta, aux = u.apply(p[u.name], src, None, ectx)
                g_out = (g1 if j % 2 == 0 else g2).to(delta.dtype)
                outs, gouts = [delta], [g_out]
                if aux is not None and aux.requires_grad:
                    outs.append(aux)
                    gouts.append(gld.to(aux.dtype))
                inputs = [src, *(v for _, v in leaves), *extra_leaves.values()]
                grads = torch.autograd.grad(outs, inputs, gouts, allow_unused=True)
            gsrc = grads[0]
            delta = delta.detach()
            if j % 2 == 0:  # read x2, wrote x1
                x1 = x1 - delta.to(x1.dtype)
                if gsrc is not None:
                    g2 = g2 + gsrc.to(g2.dtype)
            else:  # read x1, wrote x2
                x2 = x2 - delta.to(x2.dtype)
                if gsrc is not None:
                    g1 = g1 + gsrc.to(g1.dtype)
            for (name, v), g in zip(leaves, grads[1: 1 + len(leaves)]):
                gparams[name] = g if g is not None else torch.zeros_like(v)
            for (name, v), g in zip(extra_leaves.items(), grads[1 + len(leaves):]):
                if g is not None:
                    gextra = gextra or {}
                    gextra[name] = gextra[name] + g if name in gextra else g
        return (x1, x2), (g1, g2), gparams, gextra

    def fwd_std(self, p, x, cache, ctx: Ctx):
        """Standard single-stream residual stack; returns ``(x, aux)``."""
        aux = _zero_aux(x)
        for u in self.units:
            delta, a = u.apply(p[u.name], x, None if cache is None else cache.get(u.name, {}),
                               ctx)
            if a is not None:
                aux = aux + a
            x = x + delta.to(x.dtype)
        return x, aux


@dataclass(frozen=True)
class StackLayout:
    main: SuperBlock
    tail: Optional[SuperBlock] = None  # zamba2's remainder blocks
    has_shared_attn: bool = False


def decoder_layout(cfg: ModelConfig) -> StackLayout:
    """Superblock layout of the decoder stack."""
    if cfg.family in ("dense", "vlm"):
        return StackLayout(SuperBlock((attention_unit(cfg), ffn_unit(cfg)), cfg.n_layers))
    if cfg.family == "moe":
        if cfg.moe.interleave == 1:
            return StackLayout(SuperBlock((attention_unit(cfg), moe_unit(cfg)), cfg.n_layers))
        if cfg.moe.interleave != 2 or cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: MoE interleave {cfg.moe.interleave} over "
                             f"{cfg.n_layers} layers has no layout (1, or 2 over an even depth)")
        # the MoE unit is the fourth: it reads x1 and writes x2
        units = (attention_unit(cfg, "attn0"), ffn_unit(cfg, "ffn0"),
                 attention_unit(cfg, "attn1"), moe_unit(cfg, "moe1"))
        return StackLayout(SuperBlock(units, cfg.n_layers // 2))
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        return StackLayout(SuperBlock((rwkv_time_unit(cfg), rwkv_channel_unit(cfg)),
                                      cfg.n_layers))
    if cfg.family == "hybrid":
        # zamba2: k Mamba2 blocks, then one application of the shared
        # transformer block (attention + FFN, weights in ``Ctx.extra``)
        k = cfg.hybrid_attn_every
        n_main, n_tail = cfg.n_layers // k, cfg.n_layers % k
        units = tuple(mamba_unit(cfg, f"mamba{i}") for i in range(k)) + (
            attention_unit(cfg, "shared_attn", shared=True),
            ffn_unit(cfg, "shared_ffn", shared=True),
        )
        tail = None
        if n_tail:
            tail = SuperBlock(tuple(mamba_unit(cfg, f"mamba{i}") for i in range(n_tail)), 1)
        return StackLayout(SuperBlock(units, n_main), tail, has_shared_attn=True)
    if cfg.family == "audio":  # the whisper decoder
        units = (attention_unit(cfg, "self_attn"),
                 attention_unit(cfg, "cross_attn", cross=True), ffn_unit(cfg))
        return StackLayout(SuperBlock(units, cfg.n_layers))
    raise ValueError(f"no layout for family {cfg.family!r} ({cfg.name})")


def encoder_layout(cfg: ModelConfig) -> StackLayout:
    """The whisper encoder: non-causal attention and the MLP."""
    units = (attention_unit(cfg, causal=False), ffn_unit(cfg))
    return StackLayout(SuperBlock(units, cfg.encoder_layers))
