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
