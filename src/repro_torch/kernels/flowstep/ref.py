"""Plain PyTorch versions of the fused flow step (actnorm -> conv1x1 ->
coupling).  They are the CPU path of ``ops.py``, the oracle the CUDA kernels
are held against on the card, and the port of the reference's
``kernels/flowstep/ref.py`` (held to <=1e-4 in f32).

Layout: the (B, M, C) view; ``ca = raw.shape[-1]`` channels are transformed
by the coupling given the conditioner outputs ``raw``/``t`` (B, M, ca).  The
emitted logdet is the coupling's only; the actnorm and 1x1-conv logdets are
per-batch constants the caller adds.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import product_3xtf32, stream_ld, stream_rows
from repro_torch.kernels.flowstep.flowstep import FLOW_PLAN


def flowstep_fwd_ref(x, an_log_s, an_b, w, raw, t, clamp: float = 2.0):
    """(y, ld_coupling): actnorm -> x @ W -> affine-couple the first half."""
    ca = raw.shape[-1]
    x1 = x.float() * torch.exp(an_log_s.float()) + an_b.float()
    x2 = x1 @ w.float()
    log_s = clamp * torch.tanh(raw.float() / clamp)
    ya = x2[..., :ca] * torch.exp(log_s) + t.float()
    y = torch.cat([ya, x2[..., ca:]], dim=-1)
    return y.to(x.dtype), torch.sum(log_s, dim=(1, 2))


def flowstep_inv_ref(y, an_log_s, an_b, w_inv, raw, t, clamp: float = 2.0):
    """Exact inverse of :func:`flowstep_fwd_ref` given ``W^-1``."""
    ca = raw.shape[-1]
    log_s = clamp * torch.tanh(raw.float() / clamp)
    xa = (y[..., :ca].float() - t.float()) * torch.exp(-log_s)
    x2 = torch.cat([xa, y[..., ca:].float()], dim=-1)
    x1 = x2 @ w_inv.float()
    x = (x1 - an_b.float()) * torch.exp(-an_log_s.float())
    return x.to(y.dtype)


def flowstep_stream_ref(x, an_log_s, an_b, w, raw, t, clamp: float = 2.0, inverse: bool = False):
    """The stream kernels' arithmetic in plain PyTorch (``csrc/flowstep.cu``,
    ``flow_stream``; C in ``FLOW_PLAN``, ca = C/2).  Forward: ``(y, ld)``,
    y as :func:`flowstep_fwd_ref` computes it, ld summed in the kernel's
    order: a tile is ``stream_rows(C, FLOW_PLAN)`` rows of one batch; each lane adds the
    log_s of its rows and then its columns (lane l: rows (l // G) RPL + u,
    columns (l % G) OUT + j < ca, G = C // OUT), the tile's 32 lanes by the
    kernel's shuffle tree, then per batch the tiles' sums as
    ``ld_reduce_kernel`` adds them (lane l takes tiles l, l + 32, ..., then
    the tree).  With ``inverse`` (x = y, w = W^-1): x as
    :func:`flowstep_inv_ref` computes it, v = (y - t) e^-ls kept in f32."""
    if inverse:
        return flowstep_inv_ref(x, an_log_s, an_b, w, raw, t, clamp=clamp)
    y, _ = flowstep_fwd_ref(x, an_log_s, an_b, w, raw, t, clamp=clamp)
    c = x.shape[-1]
    out, rpl, _ = FLOW_PLAN[c]
    log_s = clamp * torch.tanh(raw.float() / clamp)
    ld = stream_ld(log_s, stream_rows(c, FLOW_PLAN), rpl, min(out, raw.shape[-1]), c // out)
    return y, ld


def spine_bwd_ref(x2, gx2, w, w_inv, an_log_s, an_b):
    """Reversible backward of actnorm -> 1x1 conv from the conv output side.

    Given the conv output ``x2`` and its cotangent ``gx2`` (which already
    carries the conditioner's contribution on the untransformed channels)::

        x1     = x2 @ W^-1                  (conv input, rebuilt)
        x      = (x1 - b) * exp(-log_s)     (step input, rebuilt)
        gx1    = gx2 @ W^T
        gx     = gx1 * exp(log_s)
        gW     = sum_{b,m} x1^T gx2         (f32)
        g_b    = sum_{b,m} gx1
        g_logs = sum_{b,m} gx1 * (x1 - b)

    Returns ``(x, gx, gW, g_log_s, g_b)``; the logdet cotangents are the
    caller's to add.
    """
    ls32, b32 = an_log_s.float(), an_b.float()
    x2_32, gx2_32 = x2.float(), gx2.float()
    x1 = x2_32 @ w_inv.float()
    x = (x1 - b32) * torch.exp(-ls32)
    gx1 = gx2_32 @ w.float().T
    gx = gx1 * torch.exp(ls32)
    gw = torch.einsum("bmi,bmj->ij", x1, gx2_32)
    g_b = torch.sum(gx1, dim=(0, 1))
    g_log_s = torch.sum(gx1 * (x1 - b32), dim=(0, 1))
    return x.to(x2.dtype), gx.to(x2.dtype), gw, g_log_s, g_b


def spine_tiled_ref(x2, gx2, w, w_inv, an_log_s, an_b, plan=None):
    """The cluster kernel's arithmetic in plain PyTorch (``csrc/flowstep.cu``,
    ``spine_bwd_cluster_kernel``): the same function as
    :func:`spine_bwd_ref`, with gW's products in 3xTF32 (x1 split into a TF32
    hi and lo, gx2 too when it is f32; bf16 gx2 is exact in TF32) and the
    sums over rows taken as the kernel's launch ``plan`` (``spine_plan`` in
    ``kernels/flowstep/flowstep.py``; one block when None) takes them: each
    block sums its rows, the blocks of a cluster are added in rank order and
    the clusters in order.  Returns ``(x, gx, gW, g_log_s, g_b)``."""
    b, m, c = x2.shape
    ls32, b32 = an_log_s.float(), an_b.float()
    x1 = x2.float().reshape(-1, c) @ w_inv.float()
    gx2_32 = gx2.float().reshape(-1, c)
    gx1 = gx2_32 @ w.float().T
    x = ((x1 - b32) * torch.exp(-ls32)).to(x2.dtype).reshape(b, m, c)
    gx = (gx1 * torch.exp(ls32)).to(x2.dtype).reshape(b, m, c)
    n = b * m
    if plan is None:
        plan = {"clusters": 1, "cluster_size": 1, "cta_rows": n}
    split_b = x2.dtype == torch.float32
    total = None
    for cid in range(plan["clusters"]):
        cluster = None
        for rank in range(plan["cluster_size"]):
            r0 = min((cid * plan["cluster_size"] + rank) * plan["cta_rows"], n)
            r1 = min(r0 + plan["cta_rows"], n)
            rows = slice(r0, r1)
            d = x1[rows] - b32
            part = torch.cat([product_3xtf32(x1[rows].T, gx2_32[rows], split_b).reshape(-1),
                              torch.sum(gx1[rows] * d, dim=0), torch.sum(gx1[rows], dim=0)])
            cluster = part if cluster is None else cluster + part
        total = cluster if total is None else total + cluster
    return x, gx, total[: c * c].view(c, c), total[c * c: c * c + c], total[c * c + c:]
