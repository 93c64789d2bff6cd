"""Plain PyTorch flash-attention oracle (GQA, top-left causal mask): the CPU
path of ``kernels/attention/ops.py::flash_sdpa``, the version the CUDA kernel
is held against on the card, and the port of the reference's
``kernels/attention/ref.py::attention_ref``.

The math is in f32 whatever the inputs' type, and the output is in q's type.
It forms the whole (Sq, Skv) score matrix of every head: nothing on the
card's path calls it."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (d**-0.5)
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(skv, device=q.device)
        s = torch.where(pos_q[:, None] >= pos_k[None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
