"""Public wrapper of the SSD kernel, the port of the reference's
``kernels/ssd/ops.py::mamba2_ssd``.

CPU tensors take the plain version (``ref.py``), which autograd
differentiates; CUDA tensors take the hand-written kernel, or raise.  The
kernel computes the forward only and serves the models' prefill and decode;
on the card it is called through ``forward_only``, so a gradient through it
raises.  The models train through the plain scans of ``nn/ssm.py``
(``scan_on_kernel``), as the reference trains through ``lax.scan``.  Both keep the TPU kernel's contract: the
chunk is ``min(chunk, S)`` and must divide S, and y comes back in x's
dtype."""

from __future__ import annotations

from repro_torch.kernels.common import forward_only, use_plain
from repro_torch.kernels.ssd import ssd as _k
from repro_torch.kernels.ssd.ref import ssd_ref

_ssd_on_card = forward_only(_k.ssd_scan, "ssd_scan")


def mamba2_ssd(x, da, dt, b_in, c_in, chunk: int = 128, state0=None):
    """x: (B, H, S, P); da, dt: (B, H, S) f32; b_in, c_in: (B, S, N);
    state0: (B, H, P, N) f32 or None (zeros) -> (y (B, H, S, P) in x's
    dtype, state (B, H, P, N) f32)."""
    tensors = (x, da, dt, b_in, c_in) + (() if state0 is None else (state0,))
    if use_plain(*tensors):
        _k.check_chunk(x.shape[2], chunk)
        y, state = ssd_ref(x, da, dt, b_in, c_in, state0)
        return y.to(x.dtype), state
    return _ssd_on_card(x, da, dt, b_in, c_in, chunk=chunk, state0=state0)
