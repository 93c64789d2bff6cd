"""Plain PyTorch flash-attention oracle (GQA, top-left causal mask): the CPU
path of ``kernels/attention/ops.py::flash_sdpa``, the version the CUDA kernel
is held against on the card, and the port of the reference's
``kernels/attention/ref.py::attention_ref``.

The math is in f32 whatever the inputs' type, and the output is in q's type.
It forms the whole (Sq, Skv) score matrix of every head: nothing on the
card's path calls it.  :func:`attention_tf32_ref` mirrors the TF32 kernel's
arithmetic (3xTF32 products, the online softmax over 64-key tiles) in plain
PyTorch, so that the CPU tests hold its design to the f32 gate."""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.attention import TF32_KEYS
from repro_torch.kernels.common import product_3xtf32

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
    # one softmax kernel, each row whole: on an x86 CPU an elementwise
    # torch.exp split over worker threads can come out up to 1.5e-4 off in
    # one thread's chunk on its first call (MKL's exp), so the result moved
    # with the threads' timing
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def attention_tf32_ref(q, k, v, causal: bool = True):
    """The TF32 kernel's arithmetic (``csrc/attention.cu``,
    ``flash_attention_tf32_kernel``) in plain PyTorch, f32 in and out: key
    tiles of ``TF32_KEYS``; S = Q K^T and O += P V each as three TF32
    products of split operands (``product_3xtf32``: hi and lo of both
    operands, the lo x lo term dropped; the products summed exactly, where
    the tensor cores sum in f32); S scaled by D^-1/2, causally hidden keys
    at -1e30 (keys past Skv, the kernel's -inf, add nothing: the last tile
    is short); the online softmax in f32 with the
    running max, its rescale ``exp(m_old - m_new)`` of O and of the row sum,
    and O / l at the end.  A tile wholly above the diagonal adds exactly
    nothing here (P = 0, the rescale 1), so the kernel skips it."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=1)
    v = v.float().repeat_interleave(hq // hkv, dim=1)
    q = q.float()
    pos_q = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hq, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq, 1), device=q.device)
    o = torch.zeros((b, hq, sq, d), device=q.device)
    for k0 in range(0, skv, TF32_KEYS):
        kt, vt = k[:, :, k0:k0 + TF32_KEYS], v[:, :, k0:k0 + TF32_KEYS]
        s = product_3xtf32(q, kt.transpose(-1, -2)) * (d**-0.5)
        if causal:
            pos_k = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            s = torch.where(pos_q >= pos_k, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + product_3xtf32(p, vt)
        m = m_new
    return o / l
