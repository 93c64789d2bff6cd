"""Flow configurations the port serves and trains.

``FlowConfig`` and every configuration of the reference
(``repro/configs/flows.py``): GLOW, RealNVP, cHINT and the hyperbolic
network; the port keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FlowConfig:
    name: str
    kind: str  # realnvp | glow | glow_scanned | chint | hyperbolic
    depth: int = 8
    hidden: int = 64
    n_scales: int = 3
    k_steps: int = 8
    grad_mode: str = "invertible"


GLOW_PAPER = FlowConfig(name="glow-paper", kind="glow", n_scales=3, k_steps=8, hidden=64)
# the exact setting of the paper's Fig. 1/2: RGB images, batch 8
GLOW_FIG1 = FlowConfig(name="glow-fig1", kind="glow", n_scales=3, k_steps=8, hidden=64)
# the Fig. 1 net, unrolled layer by layer, on the fused coupling kernels and
# the coupled backward: the same density model as GLOW_SCANNED
GLOW_COUPLED = FlowConfig(
    name="glow-coupled", kind="glow", n_scales=3, k_steps=8, hidden=64,
    grad_mode="coupled",
)
# the production path of the reference: scanned homogeneous flow-step stacks
# through the fused flow-step kernel, 3 scales x 8 steps, hidden 64
GLOW_SCANNED = FlowConfig(
    name="glow-scanned", kind="glow_scanned", n_scales=3, k_steps=8, hidden=64,
    grad_mode="coupled",
)

REALNVP_2D = FlowConfig(name="realnvp-2d", kind="realnvp", depth=8, hidden=128)
# conditional HINT, the amortized-posterior flow (paper section 4)
CHINT_POSTERIOR = FlowConfig(name="chint-posterior", kind="chint", depth=4, hidden=128)
# cHINT on the fused recursive backward: one cross-conditioner evaluation a
# node in the backward, each cross backward through coupling_bwd
CHINT_COUPLED = FlowConfig(
    name="chint-coupled", kind="chint", depth=4, hidden=128, grad_mode="coupled"
)

# volume-preserving leapfrog net (paper section 3: hyperbolic networks);
# depth is the layer count, O(1) activation memory at any depth
HYPERBOLIC_DEEP = FlowConfig(
    name="hyperbolic-deep", kind="hyperbolic", depth=16, grad_mode="coupled"
)


def build_flow(cfg: FlowConfig, grad_mode: str | None = None, *, coupled_bwd: str = "auto",
               channels: int = 3, d_theta: int | None = None, d_cond: int = 64,
               generator: torch.Generator | None = None, device=None):
    """The flow ``cfg`` describes, on ``device`` (``cuda`` unless named).
    ``coupled_bwd`` is the scanned stacks' backward strategy
    (``core/glow_scan.py::resolve_coupled_bwd``); the unrolled GLOW always
    takes the fused reverse walk, as in the reference.  A cHINT flow takes
    its widths, ``d_theta`` features conditioned on ``d_cond`` (by default
    the reference's ``seismic-uq`` scenario: 32 parameters, a 64-wide
    summary), at the reference's ``build_chint`` recursion of 2.  A RealNVP
    flow is ``d_theta`` features wide, 2 by default (``REALNVP_2D``'s
    two-dimensional densities); a hyperbolic network runs on the pair
    state of ``channels``-channel images, with the reference's
    ``build_hyperbolic`` defaults (alpha 0.25, 3x3 convolutions)."""
    from repro_torch.core.conditional import build_chint
    from repro_torch.core.glow import build_glow
    from repro_torch.core.glow_scan import build_glow_scanned
    from repro_torch.core.hyperbolic import build_hyperbolic
    from repro_torch.core.realnvp import build_realnvp

    if cfg.kind == "glow":
        return build_glow(
            n_scales=cfg.n_scales, k_steps=cfg.k_steps, hidden=cfg.hidden,
            grad_mode=grad_mode or cfg.grad_mode, channels=channels, generator=generator,
            device=device,
        )
    if cfg.kind == "glow_scanned":
        return build_glow_scanned(
            n_scales=cfg.n_scales, k_steps=cfg.k_steps, hidden=cfg.hidden,
            grad_mode=grad_mode or cfg.grad_mode, coupled_bwd=coupled_bwd, channels=channels,
            generator=generator, device=device,
        )
    if cfg.kind == "chint":
        return build_chint(d_theta or 32, d_cond, depth=cfg.depth, hidden=cfg.hidden,
                           grad_mode=grad_mode or cfg.grad_mode, generator=generator,
                           device=device)
    if cfg.kind == "realnvp":
        return build_realnvp(d_theta or 2, depth=cfg.depth, hidden=cfg.hidden,
                             grad_mode=grad_mode or cfg.grad_mode, generator=generator,
                             device=device)
    if cfg.kind == "hyperbolic":
        return build_hyperbolic(channels, depth=cfg.depth, grad_mode=grad_mode or cfg.grad_mode,
                                generator=generator, device=device)
    raise ValueError(cfg.kind)
