"""Plain PyTorch oracle of the Mamba2 SSD scan, the naive sequential
recurrence: the CPU path of ``kernels/ssd/ops.py::mamba2_ssd``, the version
the CUDA kernel is held against on the card, and the port of the
reference's ``kernels/ssd/ref.py::ssd_ref``, with one more input, the
initial state.

    h_t = exp(da_t) h_{t-1} + dt_t x_t ⊗ B_t;   y_t = h_t @ C_t

A Python loop over time, in f32 whatever the inputs' type."""

from __future__ import annotations

import torch


def ssd_ref(x, da, dt, b_in, c_in, state0=None):
    """x: (B, H, S, P); da, dt: (B, H, S); b_in, c_in: (B, S, N); state0:
    (B, H, P, N) or None (zeros) -> (y: (B, H, S, P), state: (B, H, P, N)),
    both f32."""
    bsz, h, s, p = x.shape
    n = b_in.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    ys = []
    for t in range(s):
        xt, bt, ct = x[:, :, t].float(), b_in[:, t].float(), c_in[:, t].float()
        dat, dtt = da[:, :, t].float(), dt[:, :, t].float()
        state = state * torch.exp(dat)[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", xt, bt, dtt)
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    return torch.stack(ys, dim=2), state
