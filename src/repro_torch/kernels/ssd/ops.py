"""Public wrapper of the SSD kernel, the port of the reference's
``kernels/ssd/ops.py::mamba2_ssd``.

CPU tensors take the plain version (``ref.py``), which autograd
differentiates; CUDA tensors take the hand-written kernel, or raise.  The
kernel computes the forward only and serves the models' prefill and decode;
on the card it is called through ``forward_only``, so a gradient through it
raises.  The models train through the plain scans of ``nn/ssm.py``
(``scan_on_kernel``), as the reference trains through ``lax.scan``.  Both keep the TPU kernel's contract: the
chunk is ``min(chunk, S)`` and must divide S, and y comes back in x's
dtype.

Meta tensors take the meta route: the outputs' shapes and dtypes, and one
``ssd_scan`` launch recorded in ``utils/cost.py`` with the bytes and
operations ``PERF.md``'s bound column reckons for it."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import forward_only, on_meta, use_plain
from repro_torch.kernels.ssd import ssd as _k
from repro_torch.kernels.ssd.ref import ssd_ref

_ssd_on_card = forward_only(_k.ssd_scan, "ssd_scan")


def mamba2_ssd(x, da, dt, b_in, c_in, chunk: int = 128, state0=None):
    """x: (B, H, S, P); da, dt: (B, H, S) f32; b_in, c_in: (B, S, N);
    state0: (B, H, P, N) f32 or None (zeros) -> (y (B, H, S, P) in x's
    dtype, state (B, H, P, N) f32)."""
    tensors = (x, da, dt, b_in, c_in) + (() if state0 is None else (state0,))
    if on_meta(*tensors):
        return ssd_meta(x, da, dt, b_in, c_in, chunk, state0)
    if use_plain(*tensors):
        _k.check_chunk(x.shape[2], chunk)
        y, state = ssd_ref(x, da, dt, b_in, c_in, state0)
        return y.to(x.dtype), state
    return _ssd_on_card(x, da, dt, b_in, c_in, chunk=chunk, state0=state0)


def ssd_cost(b: int, h: int, s: int, p: int, n: int, c: int, es: int) -> tuple[int, int]:
    """``(bytes, operations)`` of one launch at (B, H, S, P, N, chunk) with
    x and y of ``es`` bytes an element: x in and y out, da and dt in (f32),
    B and C in, the (P, N) state in and out; per (batch, head, chunk) C
    state^T and the update over all c rows and G (x dt) over the c (c + 1) /
    2 causal pairs, G = C B^T once per (batch, chunk)."""
    nbytes = 2 * es * b * h * s * p + 8 * b * h * s + 2 * es * b * s * n + 8 * b * h * p * n
    return nbytes, (b * h * (s // c) * (4 * c * n * p + p * c * (c + 1))
                    + b * (s // c) * n * c * (c + 1))


def ssd_meta(x, da, dt, b_in, c_in, chunk: int = 128, state0=None):
    """The meta route: ``(y, state)`` shaped and typed as the kernel's, one
    launch recorded, nothing computed."""
    from repro_torch.utils.cost import record_launch

    b, h, s, p = x.shape
    n = b_in.shape[-1]
    c = min(chunk, s)
    _k.check_chunk(s, chunk)
    record_launch("ssd_scan", *ssd_cost(b, h, s, p, n, c, x.element_size()))
    return x.new_empty((b, h, s, p)), x.new_empty((b, h, p, n), dtype=torch.float32)
