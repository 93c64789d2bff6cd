"""GLOW: a multiscale flow of ActNorm -> 1x1 conv -> affine coupling steps,
unrolled as a plain layer chain.

The port of the reference's ``repro/core/glow.py::build_glow``: the same
density model as ``build_glow_scanned``, with one module per layer instead
of stacked parameters, so its parameter tree is the reference's
``build_glow`` tree and every layer trains through its own ``coupled``
hook.  The network state is a tuple ``(x, z_1, ..., z_k)``: every scale but
the last ends with a ``Split``.
"""

from __future__ import annotations

import torch

from repro_torch.core.actnorm import ActNorm
from repro_torch.core.chain import InvertibleChain, OnFirst, Pack, Split
from repro_torch.core.conv1x1 import Conv1x1
from repro_torch.core.coupling import AffineCoupling
from repro_torch.core.haar import HaarSqueeze, Squeeze
from repro_torch.core.types import Invertible, resolve_device
from repro_torch.nn.nets import CouplingCNN


def build_glow(
    n_scales: int = 3,
    k_steps: int = 8,
    hidden: int = 64,
    grad_mode: str = "invertible",
    haar: bool = True,
    clamp: float = 2.0,
    kernel_inverse: bool = False,
    kernel_training: bool | None = None,
    *,
    channels: int = 3,
    generator: torch.Generator | None = None,
    device=None,
) -> InvertibleChain:
    """GLOW for (B, H, W, channels) inputs (H, W divisible by
    2**n_scales): ``Pack``, then per scale a squeeze and ``k_steps`` x
    (``OnFirst(ActNorm)``, ``OnFirst(Conv1x1)``, ``OnFirst(AffineCoupling)``),
    then a ``Split`` (but after the last scale).

    ``kernel_inverse`` sends the sampling inverse through the fused coupling
    kernel; ``kernel_training`` sends the forward and the coupled backward
    through the fused kernels, and defaults to on exactly when
    ``grad_mode="coupled"``, as in the reference.  Parameters are drawn from
    ``generator`` on the CPU, in layer order, then moved to ``device``
    (``cuda`` unless named; raises without a card)."""
    if kernel_training is None:
        kernel_training = grad_mode == "coupled"
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    squeeze = HaarSqueeze if haar else Squeeze
    layers: list[Invertible] = [Pack()]
    c = channels
    for scale in range(n_scales):
        c *= 4
        layers.append(OnFirst(squeeze()))
        for _ in range(k_steps):
            ca = c // 2
            layers.append(OnFirst(ActNorm(c, device=dev)))
            layers.append(OnFirst(Conv1x1(c, generator=gen, device=dev)))
            net = CouplingCNN(c - ca, 2 * ca, hidden, generator=gen, device=dev)
            layers.append(OnFirst(AffineCoupling(net, clamp=clamp, kernel_inverse=kernel_inverse,
                                                 kernel_training=kernel_training)))
        if scale != n_scales - 1:
            layers.append(Split())
            c //= 2
    return InvertibleChain(layers, grad_mode=grad_mode)
