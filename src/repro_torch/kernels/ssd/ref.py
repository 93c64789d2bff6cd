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


def ssd_passes_ref(x, da, dt, b_in, c_in, chunk: int, state0=None, product=torch.matmul):
    """The CUDA kernel's decomposition in plain PyTorch (``csrc/ssd.cu``,
    passes 1-5), in f32: the same function as :func:`ssd_ref`, computed as
    SSD's chunked passes.  Per (batch, chunk): cum = cumsum(da) within the
    chunk (summed in float64 and kept as an f32 high and low part, so that
    cum_t - cum_s between close steps keeps f32 precision where cum itself
    is large) and G = C B^T, once for all heads.  Per (batch, head, chunk): the
    chunk's own state sum_s (B_s exp(cum_end - cum_s) dt_s) ⊗ x_s.  The carry
    in chunk order from ``state0`` (or zeros), giving the state entering each
    chunk and the final state.  Then y = (C state_in^T) exp(cum_t) + (G *
    exp(cum_t - cum_s) dt_s, only where t >= s) x.  ``product`` computes
    each of the four matrix products, with the operands the kernel gives its
    tensor cores.  The chunk must divide S.  Shapes as :func:`ssd_ref`."""
    bsz, h, s, p = x.shape
    n = b_in.shape[-1]
    k = s // chunk
    xc = x.float().reshape(bsz, h, k, chunk, p)
    cum64 = da.double().reshape(bsz, h, k, chunk).cumsum(-1)
    cum = cum64.float()
    cum_lo = (cum64 - cum.double()).float()
    dtc = dt.float().reshape(bsz, h, k, chunk)
    bc = b_in.float().reshape(bsz, k, chunk, n)
    cc = c_in.float().reshape(bsz, k, chunk, n)
    g = product(cc, bc.transpose(-1, -2))  # (b, k, t, s), once per (batch, chunk)
    w = torch.exp((cum[..., -1:] - cum) + (cum_lo[..., -1:] - cum_lo)) * dtc
    bw = bc[:, None] * w[..., None]  # (b, h, k, s, n)
    local = product(bw.transpose(-1, -2), xc).transpose(-1, -2)  # (b, h, k, p, n)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    entering = []
    for j in range(k):
        entering.append(state)
        state = state * torch.exp(cum[:, :, j, -1])[..., None, None] + local[:, :, j]
    st_in = torch.stack(entering, dim=2)
    y = product(cc[:, None], st_in.transpose(-1, -2)) * torch.exp(cum)[..., None]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    d = (cum[..., :, None] - cum[..., None, :]) + (cum_lo[..., :, None] - cum_lo[..., None, :])
    gd = g[:, None] * torch.exp(torch.where(causal, d, float("-inf"))) * dtc[..., None, :]
    y = y + product(gd, xc)
    return y.reshape(bsz, h, s, p), state
