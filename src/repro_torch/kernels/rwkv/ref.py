"""Plain PyTorch oracle of the RWKV6 wkv recurrence: the CPU path of
``kernels/rwkv/ops.py::rwkv6_wkv``, the version the CUDA kernel is held
against on the card, and the port of the reference's
``kernels/rwkv/ref.py::wkv_ref``, with one more input, the initial state.

    y_t = r_t · (S + u ⊙ (k_t ⊗ v_t));   S <- diag(w_t) S + k_t ⊗ v_t

A Python loop over time, in f32 whatever the inputs' type."""

from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, state0=None):
    """r, k, v, w: (B, H, S, K); u: (H, K); state0: (B, H, K, K) or None
    (zeros) -> (y: (B, H, S, K) f32, state: (B, H, K, K) f32)."""
    bsz, h, s, kd = r.shape
    uf = u.float()[None, :, :, None]
    state = (torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    ys = []
    for t in range(s):
        rt, kt, vt, wt = (x[:, :, t].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkj->bhj", rt, state + uf * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=2), state


def wkv_tiled_ref(r, k, v, w, u, state0=None):
    """The CUDA kernel's arithmetic in plain PyTorch (``csrc/rwkv.cu``): the
    same function as :func:`wkv_ref`, with y reassociated as
    ``r_t S + (r_t . (u k_t)) v_t`` and its sums taken in the kernel's order.
    The K rows of the state are 8 row groups of K/8; each group's part of
    ``r_t S`` is a sum over its rows in order, and the groups are added as
    ``((g0 + g4) + (g2 + g6)) + ((g1 + g5) + (g3 + g7))``.  ``r_t . (u k_t)``
    is K/8 sums of 8 products in order, added as ``(p0 + p1) + (p2 + p3)``...
    Same results as :func:`wkv_ref`."""
    bsz, h, s, kd = r.shape
    ti = kd // 8
    uf = u.float()
    state = (torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float().clone())
    ys = []
    for t in range(s):
        rt, kt, vt, wt = (x[:, :, t].float() for x in (r, k, v, w))
        prod = (rt[..., :, None] * state).view(bsz, h, 8, ti, kd)
        part = prod[:, :, :, 0]
        for a in range(1, ti):
            part = part + prod[:, :, :, a]
        for half in (4, 2, 1):  # row group g with g ^ half, lowest bit last
            part = part[:, :, :half] + part[:, :, half:2 * half]
        ruk = (rt * uf * kt).view(bsz, h, kd // 8, 8)
        dots = ruk[..., 0]
        for e in range(1, 8):
            dots = dots + ruk[..., e]
        while dots.shape[-1] > 1:  # (p0 + p1) + (p2 + p3) ...
            dots = dots[..., 0::2] + dots[..., 1::2]
        ys.append(part[:, :, 0] + dots * vt)
        state = wt[..., :, None] * state + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=2), state
