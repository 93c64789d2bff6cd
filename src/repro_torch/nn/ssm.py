"""State-space sequence mixers, Mamba2 (SSD) and RWKV6 (Finch): the port of
the reference's ``nn/ssm.py``.

Each mixer is a function of its parameters, its input and an explicit
recurrent ``state``, and returns the new state beside its output, as the
reference does; the serving units (``models/blocks.py``) copy it into their
caches.

Which scan runs is one rule, :func:`scan_on_kernel`, that both mixers call:
a mixer that carries a ``state`` (serving: prefill and decode, where the
units pass their caches) on CUDA tensors launches the hand-written kernel
(``_wkv_scan`` and ``_wkv_scan_chunked`` through
``kernels/rwkv/ops.py::rwkv6_wkv``, for every S including decode's S = 1;
``_ssd_chunk_scan`` through ``kernels/ssd/ops.py::mamba2_ssd``); a mixer
without one (training) runs the reference's plain scans, written here as
Python loops that autograd differentiates, on either device, as the
reference trains through ``lax.scan``; CPU tensors always take the plain
scans.  The rule reads what the call is, not whether a gradient is asked
for: the ``invertible`` engine runs its forward and inverse without grad and
rebuilds each layer's input under grad, and all three must take one route,
or each rebuilt input would carry the kernel's difference from the plain
scan.  Mamba2's single-token decode step is the plain recurrence on either
device, as in the reference.

Weights stay f32 and are cast to the activations' dtype at each use; the
scans and their states are f32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.utils.cost import full_cat, full_stack, trip_range


def _sigmoid(x):
    """``jax.nn.sigmoid``'s rounding: ``1 / (1 + exp(-x))``, each operation
    rounded to x's dtype.  PyTorch's fused ``torch.sigmoid`` and ``F.silu``
    round once; in bf16 they differ from the reference in about a third of
    the elements by one ulp, and through rwkv6's and zamba2's mixers that
    grows to 3e-2 of the largest logit.  (The FFNs keep ``F.silu``.)"""
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    """``jax.nn.silu``'s rounding: ``x * sigmoid(x)``, as ``_sigmoid``."""
    return x * _sigmoid(x)


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def _normal(generator, shape, std) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator, device=generator.device)


def mamba2_init(generator: torch.Generator, d_model: int, cfg: SSMConfig) -> dict:
    d_in, h, n = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.d_state
    dev, std = generator.device, d_model**-0.5
    return {
        "wz": _normal(generator, (d_model, d_in), std),
        "wx": _normal(generator, (d_model, d_in), std),
        "wb": _normal(generator, (d_model, n), std),
        "wc": _normal(generator, (d_model, n), std),
        "wdt": _normal(generator, (d_model, h), std),
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)), device=dev),  # softplus^-1
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones(h, device=dev),
        "conv_w": _normal(generator, (cfg.d_conv, d_in), 0.1),
        "conv_b": torch.zeros(d_in, device=dev),
        "norm": torch.ones(d_in, device=dev),
        "wo": _normal(generator, (d_in, d_model), d_in**-0.5),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along time.  x: (B, S, C); w: (K, C).

    With ``state`` ((B, K-1, C), the decode/prefill carry) prepends it in
    place of zero padding; returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, : x.shape[1]] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i : i + x.shape[1]] * w[i].to(x.dtype)
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y + b.to(x.dtype), new_state


def scan_on_kernel(state, device: torch.device) -> bool:
    """The scans' route: True (launch the CUDA kernel) for a mixer that
    carries a recurrent ``state`` on a CUDA ``device``, or on the meta
    device (the dry run reckons what the card runs: the kernels' meta
    routes); False (the plain scan) for a mixer without one, or on the
    CPU."""
    return state is not None and device.type in ("cuda", "meta")


def _ssd_chunk_scan(xh, da, dt, b_in, c_in, state0, chunk: int, kernel: bool = False):
    """Chunked SSD scan (Mamba2 sec. 6, the 'minimal' algorithm).

    xh: (B, S, H, P); da: (B, S, H) log-decays (dt * A, negative); dt:
    (B, S, H); b_in, c_in: (B, S, N) (one group, shared by the heads);
    state0: (B, H, P, N).  Returns (y (B, S, H, P), state (B, H, P, N)).
    ``kernel`` launches ``ssd_scan`` (``scan_on_kernel``'s choice), else the
    plain scan runs.  Raises unless ``chunk`` divides S, where the reference
    asserts."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if kernel:
        from repro_torch.kernels.ssd.ops import mamba2_ssd

        y, state = mamba2_ssd(xh.transpose(1, 2), da.transpose(1, 2), dt.transpose(1, 2),
                              b_in, c_in, chunk=chunk, state0=state0)
        return y.transpose(1, 2), state

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    state, ys = state0, []
    for i in trip_range(nc, xh.device):  # meta: a body traced for nc (utils/cost.py)
        sl = slice(i * chunk, (i + 1) * chunk)
        xck, dack, dtck, bck, cck = xh[:, sl], da[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        cum = torch.cumsum(dack, dim=1)  # (B, c, H)
        # contribution of the carried state
        y_state = torch.einsum("bcn,bhpn,bch->bchp", cck, state, torch.exp(cum))
        # intra-chunk (masked) quadratic part; the decay only where t >= s,
        # since exp(cum_t - cum_s) may overflow above the diagonal
        rel = cum[:, :, None, :] - cum[:, None, :, :]  # (B, c, c, H): cum_t - cum_s
        decay = torch.exp(rel.masked_fill(~mask[None, :, :, None], float("-inf")))
        cb = torch.einsum("btn,bsn->bts", cck, bck)  # (B, c, c)
        xdt = xck * dtck[..., None]  # (B, c, H, P)
        y_intra = torch.einsum("bts,btsh,bshp->bthp", cb, decay, xdt)
        # state update
        tail = torch.exp(cum[:, -1:, :] - cum)  # exp(cum_end - cum_s), (B, c, H)
        state = state * torch.exp(cum[:, -1])[..., None, None]
        state = state + torch.einsum("bsh,bsn,bshp->bhpn", tail, bck, xdt)
        ys.append(y_state + y_intra)
    return full_cat(ys, 1, nc), state


def mamba2_apply(params, x, cfg: SSMConfig, state: Optional[dict] = None):
    """x: (B, S, D).  ``state``: {"conv": (B, K-1, d_in), "ssd": (B, H, P, N)}
    or None (zero initial state, no state returned).  Returns (out, new
    state or None)."""
    bsz, s, d_model = x.shape
    d_in, h, p, n = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.head_dim, cfg.d_state

    z = x @ params["wz"].to(x.dtype)
    xs = x @ params["wx"].to(x.dtype)
    b_in = x @ params["wb"].to(x.dtype)
    c_in = x @ params["wc"].to(x.dtype)
    dt = F.softplus((x @ params["wdt"].to(x.dtype)).float() + params["dt_bias"].float())  # f32

    conv_state = None if state is None else state["conv"]
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"], conv_state)
    xs = _silu(xs)

    a = -torch.exp(params["a_log"].float())  # (H,) negative
    da = dt * a  # (B, S, H)
    xh = xs.reshape(bsz, s, h, p)

    ssd_state0 = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
                  if state is None else state["ssd"])
    if s == 1:  # decode: the plain recurrence
        decay = torch.exp(da[:, 0])  # (B, H)
        upd = torch.einsum("bn,bhp->bhpn", b_in[:, 0].float(),
                           (xh[:, 0] * dt[:, 0][..., None]).float())
        new_ssd = ssd_state0 * decay[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].float(), new_ssd)
        y = y[:, None].to(x.dtype)  # (B, 1, H, P)
    else:
        y, new_ssd = _ssd_chunk_scan(xh.float(), da, dt, b_in.float(), c_in.float(), ssd_state0,
                                     min(cfg.chunk, s), kernel=scan_on_kernel(state, xh.device))
        y = y.to(x.dtype)

    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, d_in)
    # gated RMSNorm (Mamba2), then the output projection
    yf = (y * _silu(z)).float()
    yf = yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-5)
    out = (yf.to(x.dtype) * params["norm"].to(x.dtype)) @ params["wo"].to(x.dtype)

    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype), "ssd": new_ssd}
    return out, new_state


def mamba2_state(cfg: SSMConfig, d_model: int, batch: int, dtype=torch.bfloat16,
                 device=None) -> dict:
    d_in, h = cfg.d_inner(d_model), cfg.n_heads(d_model)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_in), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, h, cfg.head_dim, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

RWKV_TIME_KEYS = ("mu", "wr", "wk", "wv", "wg", "w0", "wa", "wb", "u", "ln", "wo")
RWKV_CHAN_KEYS = ("cm_mu", "cm_wk", "cm_wv", "cm_wr")


def rwkv6_init(generator: torch.Generator, d_model: int, cfg: SSMConfig, d_ff: int,
               keys=RWKV_TIME_KEYS + RWKV_CHAN_KEYS) -> dict:
    """The reference's ``rwkv6_init``; ``keys`` names the leaves to draw
    (the time-mix and channel-mix units each take their own half)."""
    d_in = cfg.d_inner(d_model)
    dev, std = generator.device, d_model**-0.5
    lora = max(32, d_model // 64)
    make = {
        # time-mix
        "mu": lambda: 0.5 * torch.ones((5, d_model), device=dev),  # r, k, v, g, w static lerp
        "wr": lambda: _normal(generator, (d_model, d_in), std),
        "wk": lambda: _normal(generator, (d_model, d_in), std),
        "wv": lambda: _normal(generator, (d_model, d_in), std),
        "wg": lambda: _normal(generator, (d_model, d_in), std),
        # data-dependent decay (LoRA): w = exp(-exp(w0 + tanh(x A) B))
        "w0": lambda: -6.0 * torch.ones(d_in, device=dev),
        "wa": lambda: _normal(generator, (d_model, lora), std),
        "wb": lambda: _normal(generator, (lora, d_in), lora**-0.5),
        "u": lambda: _normal(generator, (d_in,), 0.1),  # bonus
        "ln": lambda: torch.ones(d_in, device=dev),  # per-head group norm gain
        "wo": lambda: _normal(generator, (d_in, d_model), d_in**-0.5),
        # channel-mix
        "cm_mu": lambda: 0.5 * torch.ones((2, d_model), device=dev),  # k, r
        "cm_wk": lambda: _normal(generator, (d_model, d_ff), std),
        "cm_wv": lambda: _normal(generator, (d_ff, d_model), d_ff**-0.5),
        "cm_wr": lambda: _normal(generator, (d_model, d_model), std),
    }
    return {key: make[key]() for key in keys}


def _token_shift(x, last):
    """xx[t] = x[t-1]; the first position gets ``last`` (the carry) or zeros.
    Returns (xx, the new carry x[:, -1])."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1), x[:, -1]


def _wkv_kernel(r, k, v, w, u, state0):
    """The wkv kernel on (B, S, H, K) tensors, by (B, H, S, K) views."""
    from repro_torch.kernels.rwkv.ops import rwkv6_wkv

    y, state = rwkv6_wkv(*(t.transpose(1, 2) for t in (r, k, v, w)), u, state0=state0)
    return y.transpose(1, 2), state


def _wkv_scan(r, k, v, w, u, state0, kernel: bool = False):
    """RWKV6 recurrence, per-token scan.

    r, k, v, w: (B, S, H, K); u: (H, K); state0: (B, H, K, K).

    y_t = r_t · (S_{t-1} + diag(u·k_t) v_t);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    (all f32).  Returns y (B, S, H, K) and the final state.  ``kernel``
    launches ``wkv_scan`` (``scan_on_kernel``'s choice), else the plain loop
    runs."""
    if kernel:
        return _wkv_kernel(r, k, v, w, u, state0)
    state, ys, n = state0, [], r.shape[1]
    for t in trip_range(n, r.device):  # meta: a body traced for n (utils/cost.py)
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]  # (B, H, K, K)
        ys.append(torch.einsum("bhk,bhkj->bhj", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, ..., :, None] * state + kv
    return full_stack(ys, 1, n), state


def _wkv_scan_chunked(r, k, v, w, u, state0, chunk: int = 16, kernel: bool = False):
    """Chunked wkv: the sequence padded to a multiple of ``chunk`` (w = 1 on
    the padding, so the state passes it unchanged), scanned chunk by chunk.
    The same function as ``_wkv_scan``; with ``kernel`` both are the kernel,
    which needs no padding."""
    if kernel:
        return _wkv_kernel(r, k, v, w, u, state0)
    s = r.shape[1]
    pad = (-s) % chunk
    if pad:
        zf = lambda x: F.pad(x, (0, 0, 0, 0, 0, pad))  # noqa: E731
        r, k, v = zf(r), zf(k), zf(v)
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    state, ys = state0, []
    # the chunks' tokens in order, one loop (meta: a body traced for s + pad)
    for t in trip_range(s + pad, r.device):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        ys.append(torch.einsum("bhk,bhkj->bhj", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, ..., :, None] * state + kv
    return full_stack(ys, 1, s + pad)[:, :s], state


def rwkv6_time_mix(params, x, cfg: SSMConfig, state: Optional[dict] = None):
    """RWKV6 attention-free token mixer.  x: (B, S, D).  ``state``:
    {"shift": (B, D), "wkv": (B, H, K, K)} or None.  Returns (out, new state
    or None)."""
    bsz, s, d_model = x.shape
    d_in, h, k_dim = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.head_dim

    last = None if state is None else state["shift"]
    xx, new_shift = _token_shift(x, last)
    dx = xx - x
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + dx * mu[i] for i in range(5))

    r = (xr @ params["wr"].to(x.dtype)).reshape(bsz, s, h, k_dim)
    k = (xk @ params["wk"].to(x.dtype)).reshape(bsz, s, h, k_dim)
    v = (xv @ params["wv"].to(x.dtype)).reshape(bsz, s, h, k_dim)
    g = _silu(xg @ params["wg"].to(x.dtype))

    # data-dependent decay in (0, 1)
    lora = torch.tanh(xw @ params["wa"].to(x.dtype)) @ params["wb"].to(x.dtype)
    w = torch.exp(-torch.exp(params["w0"].float() + lora.float())).reshape(bsz, s, h, k_dim)

    u = params["u"].float().reshape(h, k_dim)
    state0 = (torch.zeros((bsz, h, k_dim, k_dim), dtype=torch.float32, device=x.device)
              if state is None else state["wkv"])
    rkv = (r.float(), k.float(), v.float())
    kernel = scan_on_kernel(state, w.device)
    if cfg.wkv_chunk and s > 1:
        y, new_wkv = _wkv_scan_chunked(*rkv, w, u, state0, chunk=cfg.wkv_chunk, kernel=kernel)
    else:
        y, new_wkv = _wkv_scan(*rkv, w, u, state0, kernel=kernel)  # (B, S, H, K) f32

    # per-head group norm, gate, project
    var, mean = torch.var_mean(y, dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(bsz, s, d_in).to(x.dtype) * params["ln"].to(x.dtype)
    out = (y * g) @ params["wo"].to(x.dtype)

    new_state = None
    if state is not None:
        new_state = {"shift": new_shift.to(x.dtype), "wkv": new_wkv}
    return out, new_state


def rwkv6_channel_mix(params, x, state: Optional[dict] = None):
    """RWKV6 channel mixer.  x: (B, S, D); ``state``: {"shift": (B, D)} or
    None.  Returns (out, new state or None)."""
    last = None if state is None else state["shift"]
    xx, new_shift = _token_shift(x, last)
    dx = xx - x
    mu = params["cm_mu"].to(x.dtype)
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    k = torch.square(F.relu(xk @ params["cm_wk"].to(x.dtype)))
    kv = k @ params["cm_wv"].to(x.dtype)
    out = _sigmoid(xr @ params["cm_wr"].to(x.dtype)) * kv
    new_state = None if state is None else {"shift": new_shift.to(x.dtype)}
    return out, new_state


def rwkv6_state(cfg: SSMConfig, d_model: int, batch: int, dtype=torch.bfloat16,
                device=None) -> dict:
    h = cfg.n_heads(d_model)
    return {
        "time": {
            "shift": torch.zeros((batch, d_model), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, cfg.head_dim, cfg.head_dim), dtype=torch.float32,
                               device=device),
        },
        "chan": {"shift": torch.zeros((batch, d_model), dtype=dtype, device=device)},
    }
