"""Mixture-of-experts FFN with deterministic top-k routing and capacity
dispatch local to each batch row, the port of the reference's ``nn/moe.py``.

Each batch row is a group: it numbers its own tokens' places in each
expert (a cumsum over its own sequence) and fills its own ``capacity``
slots of the dispatch buffer.  Experts are stacked along a leading E axis
and run as one batched ``torch.matmul`` over E, as the reference runs them
through XLA, outside any kernel.  On a model-sharded mesh (inside
``dist.comm.bound``) the experts split over the ``model`` axis, each rank
running its block and the outputs gathered (expert parallelism,
:func:`run_experts`), where the reference constrains the buffer to
``P("model", ...)``.

Dispatch and combine run without atomics, so a result is the same bits on
every run:

* dispatch *writes* each kept token into its slot (``scatter``; kept slots
  are distinct by construction) and sends every dropped token to one
  spare slot past the buffer's end, which is cut off before the experts
  run: a dropped token never overwrites a kept one;
* combine *gathers* each token's K expert outputs (a dropped token reads a
  zero row) and sums them over k = 0..K-1 in order.

The reference adds dropped tokens' zeros into slot ``capacity - 1`` and
scatter-adds the K outputs; both give the same values.  Routing is
``torch.topk`` of the f32 softmax, so recompute-by-inversion re-routes
from the rebuilt input; the load-balance aux loss rides the scan engine's
per-sample (B,) channel.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import MODEL_AXIS, model_size
from repro_torch.nn.mlp import ffn_apply, ffn_init


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig, ffn_kind: str) -> dict:
    """The router (d_model, E), the experts' FFN weights stacked on a
    leading E axis and, with ``shared_expert``, one more FFN every token
    takes; f32, drawn on the generator's device."""
    router = d_model**-0.5 * torch.randn((d_model, cfg.n_experts), generator=generator,
                                         device=generator.device)
    first = ffn_init(generator, d_model, cfg.d_ff_expert, ffn_kind)
    experts = {k: v.new_empty((cfg.n_experts,) + v.shape) for k, v in first.items()}
    for k, v in first.items():
        experts[k][0] = v
    del first
    for e in range(1, cfg.n_experts):
        for k, v in ffn_init(generator, d_model, cfg.d_ff_expert, ffn_kind).items():
            experts[k][e] = v
    p = {"router": router, "experts": experts}
    if cfg.shared_expert:
        p["shared"] = ffn_init(generator, d_model, cfg.d_ff_expert, ffn_kind)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * tokens_per_group * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


#: the expert choices ``route`` takes in place of its own top-k while
#: ``pinned_routes`` is active, one per call in call order; None otherwise
#: (no serving or training path sets it)
_PINNED: Optional[Iterator] = None


@contextmanager
def pinned_routes(choices):
    """Within the block, the n-th ``route`` call takes ``choices[n]`` (B, S,
    K) as its expert indices, and the probabilities at them as its gate
    values: a check reruns a pass with the routing another pass chose (the
    card's bf16 gradient check holds ``autodiff`` to the choices the
    ``invertible`` backward re-routed)."""
    global _PINNED
    _PINNED = iter(choices)
    try:
        yield
    finally:
        _PINNED = None


def route(params, x: torch.Tensor, cfg: MoEConfig):
    """The routing of ``x`` (B, S, D): ``(probs (B, S, E) f32, gate values
    (B, S, K) renormalised, expert indices (B, S, K))``."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    if _PINNED is None:
        gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    else:
        expert_idx = next(_PINNED).to(probs.device)
        gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def dispatch_slots(expert_idx: torch.Tensor, cfg: MoEConfig, cap: int):
    """Each (token, k)'s slot in its row's dispatch buffer of E x ``cap``
    slots, token-major: ``(slot (B, S*K), keep (B, S*K))``.  A dropped
    token's slot is the spare one, E * ``cap``."""
    b = expert_idx.shape[0]
    e = cfg.n_experts
    flat_e = expert_idx.reshape(b, -1)
    # the one-hot laid out (B, E, S*K), so the cumsum runs along its
    # contiguous last axis: along the middle axis of (B, S*K, E) it was a
    # quarter of granite-moe's prefill on the card
    experts = torch.arange(e, device=flat_e.device)[:, None]
    onehot = (flat_e[:, None, :] == experts).to(torch.int32)
    pos = onehot.cumsum(dim=-1, dtype=torch.int32) - 1
    pos_in_e = pos.gather(1, flat_e[:, None, :])[:, 0, :].long()
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, e * cap)
    return slot, keep


def _expert_mesh(n_experts: int):
    """The bound mesh when its ``model`` axis (m > 1) divides the experts,
    else None."""
    mesh = comm.current_mesh()
    return mesh if model_size(mesh) > 1 and n_experts % model_size(mesh) == 0 else None


def _expert_block(mesh, n_experts: int) -> tuple[int, int]:
    m, r = model_size(mesh), mesh.get_local_rank(MODEL_AXIS)
    return r * n_experts // m, (r + 1) * n_experts // m


def _gather_experts(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's block of experts, in expert order (axis 0)."""
    return torch.cat(comm.all_gather(t.contiguous(), comm.mesh_group(mesh, MODEL_AXIS)).unbind(0))


class _ExpertParallel(torch.autograd.Function):
    """Model rank r runs experts ``[r E/m, (r+1) E/m)`` on the dispatched
    buffer and the outputs are gathered along the expert axis.  The
    backward takes its block's VJP (the cotangent is the same on every
    rank) and gathers the buffer's and the weights' gradients the same way,
    so every rank holds the whole gradient, as one process would."""

    @staticmethod
    def forward(ctx, buf, kind, mesh, names, *weights):
        lo, hi = _expert_block(mesh, buf.shape[0])
        out = ffn_apply({n: w[lo:hi] for n, w in zip(names, weights)}, buf[lo:hi], kind)
        ctx.save_for_backward(buf, *weights)
        ctx.kind, ctx.mesh, ctx.names = kind, mesh, names
        return _gather_experts(out, mesh)

    @staticmethod
    def backward(ctx, g):
        buf, *weights = ctx.saved_tensors
        lo, hi = _expert_block(ctx.mesh, buf.shape[0])
        with torch.enable_grad():
            b = buf[lo:hi].detach().requires_grad_()
            ws = [w[lo:hi].detach().requires_grad_() for w in weights]
            out = ffn_apply(dict(zip(ctx.names, ws)), b, ctx.kind)
            grads = torch.autograd.grad(out, [b, *ws], g[lo:hi])
        whole = [_gather_experts(t, ctx.mesh) for t in grads]
        return (whole[0], None, None, None, *whole[1:])


def run_experts(experts: dict, buf: torch.Tensor, ffn_kind: str) -> torch.Tensor:
    """The experts' FFN on the dispatched buffer (E, N, D): one batched
    product over E, or, inside ``dist.comm.bound(mesh)`` with a ``model``
    axis that divides E, expert parallelism (:class:`_ExpertParallel`).
    Routing, dispatch and combine do not change, so the result is the
    one-process result."""
    mesh = _expert_mesh(buf.shape[0])
    if mesh is None:
        return ffn_apply(experts, buf, ffn_kind)
    names = tuple(experts)
    return _ExpertParallel.apply(buf, ffn_kind, mesh, names, *(experts[n] for n in names))


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, ffn_kind: str):
    """x: (B, S, D) -> (y (B, S, D), aux (B,): the load-balance loss / B)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    probs, gate_vals, expert_idx = route(params, x, cfg)

    # the load-balance aux loss, per sample
    me = probs.mean(dim=1)
    ce = F.one_hot(expert_idx[..., 0], e).float().mean(dim=1)
    aux = e * (me * ce).sum(dim=-1) / b

    slot, keep = dispatch_slots(expert_idx, cfg, cap)
    idx = slot[..., None].expand(b, s * k, d)
    src = x.repeat_interleave(k, dim=1)  # (B, S*K, D), token-major as the slots
    buf = x.new_zeros((b, e * cap + 1, d)).scatter(1, idx, src)
    buf = buf[:, : e * cap].reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    out = run_experts(params["experts"], buf, ffn_kind)
    out = out.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    out = torch.cat([out, out.new_zeros((b, 1, d))], dim=1)  # the spare slot reads zeros

    w = (gate_vals.reshape(b, s * k) * keep).to(x.dtype)
    gathered = (out.gather(1, idx) * w[..., None]).reshape(b, s, k, d)
    y = gathered[:, :, 0]
    for j in range(1, k):
        y = y + gathered[:, :, j]
    if "shared" in params:
        y = y + ffn_apply(params["shared"], x, ffn_kind)
    return y, aux
