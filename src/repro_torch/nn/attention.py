"""Grouped-query attention with RoPE and KV-cache support, the port of the
reference's ``nn/attention.py``.

Projections are stored separately (``wq``/``wk``/``wv``/``wo``, plus
``bq``/``bk``/``bv`` with ``qkv_bias``), f32, and cast to the activations'
dtype at each use.  The attention core is the einsum path ``_sdpa``, or the
hand-written flash kernel (``kernels/attention``) when the caller asks for
``impl="flash"`` under the reference's own conditions.  The model never asks
(``models/blocks.py``), as in the reference.

Cross attention (the whisper decoder) takes its K/V from ``cross_kv`` of the
encoder output through ``attn_apply(kv_override=)``, as the reference does,
including three of its choices that the port keeps for parity: neither the
cross K/V nor the cross query adds ``bq``/``bk``/``bv`` (with ``qkv_bias``
they exist and get no gradient), RoPE turns the query at the decoder's
positions and the keys at frame positions ``0..n_frames-1``, and a causal
``AttentionConfig`` masks the cross scores by ``q_pos >= kv_pos``.

One departure, for memory: a cache is written in place (the reference's
``dynamic_update_slice`` returns a new array), and ``attn_apply`` returns
the same cache dict it was given.  A write that would run past the cache's
end raises, where the reference would clamp the write offset.

Sequence-parallel attention (``seq_shard``) splits the work over a
model-sharded mesh's ``model`` axis where the reference places sharding
constraints: the query rows of a prefill without a cache, the cache's
positions of a cached call (``attn_apply``).

Caches split by position (the reference's ``cache_pspecs(seq_fallback_model
=True)``, which ``serve/engine.py`` lays out under ``cache_seq_fallback``):
inside :func:`position_split_caches`, a cache ``attn_apply`` is given holds
model rank r's block ``[r L, (r + 1) L)`` of the cache's ``m L`` positions.
A call writes the part of its K/V that falls in the block and attends by
``seq_shard``'s max-and-sum combine over the ranks' blocks.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.config import AttentionConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import MODEL_AXIS, model_size
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e30


def attn_init(generator: torch.Generator, d_model: int, cfg: AttentionConfig) -> dict:
    dev = generator.device
    std = d_model**-0.5

    def normal(shape):
        return std * torch.randn(shape, generator=generator, device=dev)

    p = {"wq": normal((d_model, cfg.q_dim)), "wk": normal((d_model, cfg.kv_dim)),
         "wv": normal((d_model, cfg.kv_dim)), "wo": normal((cfg.q_dim, d_model))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, device=dev)
        p["bk"] = torch.zeros(cfg.kv_dim, device=dev)
        p["bv"] = torch.zeros(cfg.kv_dim, device=dev)
    return p


def _project_qkv(params, x, cfg: AttentionConfig, positions):
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _sdpa(q, k, v, cfg: AttentionConfig, q_positions, kv_positions):
    """Grouped-query scaled-dot-product attention, the einsum path.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh).  Causality compares
    absolute positions, so one code serves prefill and decode with a cache.
    The reference's rounding: the scores are formed in the inputs' dtype and
    then widened to f32; the softmax runs in f32; the probabilities are cast
    to v's dtype for the second product."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float().mul_(dh**-0.5)
    mask = None
    if cfg.causal:
        mask = q_positions[:, None] >= kv_positions[None, :]  # (Sq, Skv)
    if cfg.window:
        w_ok = q_positions[:, None] - kv_positions[None, :] < cfg.window
        mask = w_ok if mask is None else (mask & w_ok)
    if mask is not None:
        scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dh)


def _seq_mesh(n: int):
    """The bound mesh when its ``model`` axis (m > 1) divides ``n``
    sequence positions, else None (one process, or no mesh bound: the
    sequence stays whole, as the reference's constraint is a no-op there)."""
    mesh = comm.current_mesh()
    m = model_size(mesh)
    return mesh if m > 1 and n % m == 0 else None


def _block(mesh, n: int) -> tuple[int, int]:
    m, r = model_size(mesh), mesh.get_local_rank(MODEL_AXIS)
    return r * n // m, (r + 1) * n // m


class _SeqShardPrefill(torch.autograd.Function):
    """Sequence-parallel attention without a cache: model rank r takes its
    block of query rows against the whole K/V and the rows are gathered.
    The backward takes its rows' VJP (the cotangent is the same on every
    rank), gathers the query's gradient and sums K's and V's over the
    ranks, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, pos, mesh):
        lo, hi = _block(mesh, q.shape[1])
        out = _sdpa(q[:, lo:hi], k, v, cfg, pos[lo:hi], pos)
        ctx.save_for_backward(q, k, v, pos)
        ctx.cfg, ctx.mesh = cfg, mesh
        group = comm.mesh_group(mesh, MODEL_AXIS)
        return torch.cat(comm.all_gather(out.contiguous(), group).unbind(0), dim=1)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos = ctx.saved_tensors
        lo, hi = _block(ctx.mesh, q.shape[1])
        with torch.enable_grad():
            ql = q[:, lo:hi].detach().requires_grad_()
            kk, vv = k.detach().requires_grad_(), v.detach().requires_grad_()
            out = _sdpa(ql, kk, vv, ctx.cfg, pos[lo:hi], pos)
            gq, gk, gv = torch.autograd.grad(out, [ql, kk, vv], g[:, lo:hi])
        group = comm.mesh_group(ctx.mesh, MODEL_AXIS)
        gq = torch.cat(comm.all_gather(gq.contiguous(), group).unbind(0), dim=1)
        comm.all_reduce(gk, group)
        comm.all_reduce(gv, group)
        return gq, gk, gv, None, None, None


def _seq_shard_cached(q, k, v, cfg: AttentionConfig, q_positions, kv_positions, mesh):
    """Attention over a cache whose positions split over the ``model``
    axis (flash-decode): rank r scores its block of cache positions
    (:func:`_combine_blocks`)."""
    lo, hi = _block(mesh, k.shape[1])
    return _combine_blocks(q, k[:, lo:hi], v[:, lo:hi], cfg, q_positions, kv_positions[lo:hi],
                           mesh)


def _combine_blocks(q, kl, vl, cfg: AttentionConfig, q_positions, kvp, mesh):
    """Attention of ``q`` over every model rank's block of K/V positions
    (this rank's ``kl``, ``vl`` at positions ``kvp``): the softmax is
    combined across the ranks by the max of the block maxima, then by the
    sum of the exponentials, and only then is each block's weighted V
    summed over the ranks.  The rounding follows ``_sdpa``: the scores in
    the inputs' dtype widened to f32, the probabilities cast to V's dtype;
    the weighted sums run in f32 and are cast to V's dtype at the end.  No
    gradient (a cache is a serving path)."""
    b, sq, hq, dh = q.shape
    hkv = kl.shape[2]
    v = vl
    group = comm.mesh_group(mesh, MODEL_AXIS)
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl).float().mul_(dh**-0.5)
    mask = None
    if cfg.causal:
        mask = q_positions[:, None] >= kvp[None, :]
    if cfg.window:
        w_ok = q_positions[:, None] - kvp[None, :] < cfg.window
        mask = w_ok if mask is None else (mask & w_ok)
    if mask is not None:
        scores.masked_fill_(~mask, NEG_INF)
    mx = scores.amax(dim=-1, keepdim=True)
    comm.all_reduce(mx, group, op="max")
    e = torch.exp(scores - mx)
    del scores
    denom = e.sum(dim=-1, keepdim=True)
    comm.all_reduce(denom, group)
    probs = (e / denom).to(v.dtype).float()
    del e
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vl.float()).contiguous()
    comm.all_reduce(out, group)
    return out.to(v.dtype).reshape(b, sq, hq, dh)


#: the mesh whose ``model`` axis splits the caches' positions, inside
#: :func:`position_split_caches`; None otherwise
_POSITION_SPLIT: list = []


@contextlib.contextmanager
def position_split_caches(mesh):
    """Inside, every cache ``attn_apply`` is given holds this model rank's
    block of positions (see the module docstring)."""
    _POSITION_SPLIT.append(mesh)
    try:
        yield
    finally:
        _POSITION_SPLIT.pop()


def _split_cache_attend(q, k, v, cache: dict, cache_pos: int, cfg: AttentionConfig, pos1d,
                        mesh):
    """Write the part of this call's K/V (positions ``[cache_pos, cache_pos
    + S)``) that falls in this rank's block of the cache, then attend over
    every rank's block."""
    block = cache["k"].shape[1]
    lo = mesh.get_local_rank(MODEL_AXIS) * block
    end = cache_pos + k.shape[1]
    if end > block * model_size(mesh):
        raise ValueError(f"cache write [{cache_pos}, {end}) runs past its length "
                         f"{block * model_size(mesh)}")
    a, b = max(cache_pos, lo), min(end, lo + block)
    if a < b:
        cache["k"][:, a - lo:b - lo] = k[:, a - cache_pos:b - cache_pos].to(cache["k"].dtype)
        cache["v"][:, a - lo:b - lo] = v[:, a - cache_pos:b - cache_pos].to(cache["v"].dtype)
    kvp = torch.arange(lo, lo + block, device=q.device)
    return _combine_blocks(q, cache["k"], cache["v"], cfg, pos1d, kvp, mesh)


def attn_apply(
    params,
    x: torch.Tensor,
    cfg: AttentionConfig,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
    kv_override: Optional[tuple] = None,
    impl: str = "xla",
    seq_shard: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """The full attention op.

    ``kv_override=(k, v, kv_positions)`` (``cross_kv``'s) is cross
    attention: the query alone is projected (no bias) and turned at
    ``positions``, ``cache`` is returned untouched.  Without ``cache``:
    self-attention over ``x`` (prefill without reuse);
    ``impl="flash"`` takes the flash kernel when, as in the reference, the
    sequence is longer than one token, a multiple of 128, and the window is
    off; otherwise the einsum path.  With ``cache``: write this call's K/V at
    ``cache_pos`` (an int) and attend over the whole cache.  ``impl`` names
    the reference's choices, ``"xla"`` being its einsum path.

    ``seq_shard`` (the config's ``attn_seq_shard``), inside
    ``dist.comm.bound(mesh)`` with a ``model`` axis m > 1 that divides the
    sequence: without a cache each model rank attends its block of query
    rows over the whole K/V and the rows are gathered
    (:class:`_SeqShardPrefill`, differentiable); with a cache each rank
    scores its block of cache positions (:func:`_seq_shard_cached`).  The
    result is the unsharded one up to the order of f32 sums.  With no mesh
    bound, or m = 1, it changes nothing, as the reference's sharding
    constraint changes nothing on one device.  Where ``impl="flash"`` takes
    the kernel, ``seq_shard`` keeps it: every rank runs the kernel on the
    whole query, as the reference's constrained call to its kernel does."""
    b, s, _ = x.shape
    pos1d = positions[0] if positions.ndim > 1 else positions
    if kv_override is not None:
        q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k, v, kv_pos = kv_override
        out = _sdpa(q, k, v, cfg, pos1d, kv_pos)
        return out.reshape(b, s, -1) @ params["wo"].to(x.dtype), cache
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cache is None:
        mesh = _seq_mesh(s) if seq_shard and s > 1 else None
        if impl == "flash" and s > 1 and cfg.window == 0 and s % 128 == 0:
            from repro_torch.kernels.attention.ops import flash_sdpa

            of = flash_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=cfg.causal)
            out = of.transpose(1, 2)
        elif mesh is not None:
            out = _SeqShardPrefill.apply(q, k, v, cfg, pos1d, mesh)
        else:
            out = _sdpa(q, k, v, cfg, pos1d, pos1d)
    elif _POSITION_SPLIT:
        out = _split_cache_attend(q, k, v, cache, cache_pos, cfg, pos1d, _POSITION_SPLIT[-1])
    else:
        end = cache_pos + s
        if end > cache["k"].shape[1]:
            raise ValueError(f"cache write [{cache_pos}, {end}) runs past its length "
                             f"{cache['k'].shape[1]}")
        cache["k"][:, cache_pos:end] = k.to(cache["k"].dtype)
        cache["v"][:, cache_pos:end] = v.to(cache["v"].dtype)
        kv_pos = torch.arange(cache["k"].shape[1], device=x.device)
        mesh = _seq_mesh(cache["k"].shape[1]) if seq_shard else None
        if mesh is not None:
            out = _seq_shard_cached(q, cache["k"], cache["v"], cfg, pos1d, kv_pos, mesh)
        else:
            out = _sdpa(q, cache["k"], cache["v"], cfg, pos1d, kv_pos)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype), cache


def cross_kv(params, enc: torch.Tensor, cfg: AttentionConfig) -> tuple:
    """Cross-attention K/V of the encoder output ``enc`` (B, F, D):
    ``(k, v, kv_positions)``, k turned by RoPE at frame positions
    ``0..F-1``; no bias, as in the reference."""
    b, s, _ = enc.shape
    k = (enc @ params["wk"].to(enc.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (enc @ params["wv"].to(enc.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    kv_pos = torch.arange(s, device=enc.device)
    return apply_rope(k, kv_pos, cfg.rope_theta), v, kv_pos


def make_cache(cfg: AttentionConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
