"""Flow serving: batched ``log_prob`` and ``sample`` of a normalizing flow.

The port of the reference's ``serve/engine.py::FlowServeEngine`` on one
device; batch sharding over a mesh comes with the distribution slice.
Requests run under ``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributions import derive_key, std_normal_logpdf, std_normal_sample
from repro_torch.core.types import resolve_device


class FlowServeEngine:
    """Serve ``flow`` (an ``Invertible`` module) on ``device`` (``cuda``
    unless named; raises without a card).

    ``sample_flow``: an optional twin that ``sample`` inverts in place of
    ``flow``, as in the reference: a second build of the same network with
    other kernel options (``build_glow(..., kernel_inverse=True)``) that
    holds ``flow``'s own parameters, made with
    ``core.types.share_parameters(twin, flow)``.  One parameter set, two
    builds: whatever trains or moves ``flow`` is seen by the twin.  Without
    it, ``flow`` serves both calls."""

    # the sampling stream's tag, as in the reference
    _TAG_SAMPLE = 0

    def __init__(self, flow, device=None, sample_flow=None):
        self.device = resolve_device(device)
        self.flow = flow.to(self.device).eval()
        self.sample_flow = self.flow if sample_flow is None else sample_flow.to(self.device).eval()

    def _put(self, v):
        if v is None:
            return None
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        return v.to(self.device)

    def log_prob(self, x, cond=None) -> torch.Tensor:
        """Per-example log density ``log N(z; 0, I) + logdet`` of a batch."""
        with torch.inference_mode():
            z, logdet = self.flow(self._put(x), self._put(cond))
            return std_normal_logpdf(z) + logdet

    def sample(self, generator: torch.Generator, like, cond=None):
        """Draws shaped like the latent prototype ``like`` (a tensor or the
        tuple state of a multiscale flow; only shapes and dtypes are read).
        The noise comes from the stream ``derive_key(generator, tag)`` on the
        engine's device: the same generator seed gives the same draws."""
        gen = derive_key(generator, self._TAG_SAMPLE, device=self.device)
        with torch.inference_mode():
            z = std_normal_sample(gen, like)
            return self.sample_flow.inverse(z, self._put(cond))
