"""Public wrapper of the wkv6 kernel, the port of the reference's
``kernels/rwkv/ops.py::rwkv6_wkv``.

CPU tensors take the plain version (``ref.py``), which autograd
differentiates; CUDA tensors take the hand-written kernel, or raise.  The
kernel computes the forward only and serves the models' prefill and decode;
on the card it is called through ``forward_only``, so a gradient through it
raises.  The models train through the plain scans of ``nn/ssm.py``
(``scan_on_kernel``), as the reference trains through ``lax.scan``.  ``chunk`` is the TPU kernel's time tile,
kept so calls read the same in both packages: the CUDA kernel walks time in
its own tiles and takes any S, and neither choice changes the result.

Meta tensors take the meta route: the outputs' shapes and dtypes, and one
``wkv_scan`` launch recorded in ``utils/cost.py`` with the bytes and
operations ``PERF.md``'s bound column reckons for it."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import forward_only, on_meta, use_plain
from repro_torch.kernels.rwkv import rwkv as _k
from repro_torch.kernels.rwkv.ref import wkv_ref

_wkv_on_card = forward_only(_k.wkv_scan, "wkv_scan")


def rwkv6_wkv(r, k, v, w, u, chunk: int = 64, state0=None):
    """r, k, v, w: (B, H, S, K); u: (H, K); state0: (B, H, K, K) f32 or
    None (zeros) -> (y (B, H, S, K) f32, state (B, H, K, K) f32)."""
    tensors = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if on_meta(*tensors):
        return wkv_meta(r, k, v, w, u, state0)
    if use_plain(*tensors):
        return wkv_ref(r, k, v, w, u, state0)
    return _wkv_on_card(r, k, v, w, u, chunk=chunk, state0=state0)


def wkv_cost(b: int, h: int, s: int, kd: int, es: int) -> tuple[int, int]:
    """``(bytes, operations)`` of one launch at (B, H, S, K) with inputs of
    ``es`` bytes an element: r, k, v, w in, y out in f32, u in, the (K, K)
    state in and out; per (token, head) 5 K^2 + 5 K operations (y takes
    r S and (r . (u k)) v, the update w S + k v^T)."""
    return (es * 4 * b * h * s * kd + 4 * (b * h * s * kd + h * kd + 2 * b * h * kd * kd),
            b * h * s * (5 * kd * kd + 5 * kd))


def wkv_meta(r, k, v, w, u, state0=None):
    """The meta route: ``(y, state)`` shaped and typed as the kernel's, one
    launch recorded, nothing computed."""
    from repro_torch.utils.cost import record_launch

    b, h, s, kd = r.shape
    record_launch("wkv_scan", *wkv_cost(b, h, s, kd, r.element_size()))
    return (r.new_empty((b, h, s, kd), dtype=torch.float32),
            r.new_empty((b, h, kd, kd), dtype=torch.float32))
