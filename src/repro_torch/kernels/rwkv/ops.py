"""Public wrapper of the wkv6 kernel, the port of the reference's
``kernels/rwkv/ops.py::rwkv6_wkv``.

CPU tensors take the plain version (``ref.py``), which autograd
differentiates; CUDA tensors take the hand-written kernel, or raise.  The
kernel computes the forward only and serves the models' prefill and decode;
on the card it is called through ``forward_only``, so a gradient through it
raises.  The models train through the plain scans of ``nn/ssm.py``
(``scan_on_kernel``), as the reference trains through ``lax.scan``.  ``chunk`` is the TPU kernel's time tile,
kept so calls read the same in both packages: the CUDA kernel walks time in
its own tiles and takes any S, and neither choice changes the result."""

from __future__ import annotations

from repro_torch.kernels.common import forward_only, use_plain
from repro_torch.kernels.rwkv import rwkv as _k
from repro_torch.kernels.rwkv.ref import wkv_ref

_wkv_on_card = forward_only(_k.wkv_scan, "wkv_scan")


def rwkv6_wkv(r, k, v, w, u, chunk: int = 64, state0=None):
    """r, k, v, w: (B, H, S, K); u: (H, K); state0: (B, H, K, K) f32 or
    None (zeros) -> (y (B, H, S, K) f32, state (B, H, K, K) f32)."""
    tensors = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if use_plain(*tensors):
        return wkv_ref(r, k, v, w, u, state0)
    return _wkv_on_card(r, k, v, w, u, chunk=chunk, state0=state0)
