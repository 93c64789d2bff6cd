"""RealNVP for dense / tabular (B, D) inputs, the port of the reference's
``repro/core/realnvp.py``."""

from __future__ import annotations

import torch

from repro_torch.core.actnorm import ActNorm
from repro_torch.core.chain import InvertibleChain
from repro_torch.core.coupling import AffineCoupling
from repro_torch.core.types import resolve_device
from repro_torch.nn.nets import CouplingMLP


def build_realnvp(
    d: int,
    depth: int = 8,
    hidden: int = 128,
    mlp_depth: int = 2,
    grad_mode: str = "invertible",
    additive: bool = False,
    clamp: float = 2.0,
    kernel_training: bool = False,
    *,
    generator: torch.Generator | None = None,
    device=None,
) -> InvertibleChain:
    """``depth`` x (``ActNorm``, ``AffineCoupling``) over ``d`` features,
    the couplings alternating which half they transform (``flip`` on every
    odd layer), each conditioner a ``CouplingMLP`` (``mlp_depth`` hidden
    layers of ``hidden``).

    ``kernel_training`` sends each coupling's forward and its ``coupled``
    backward through the fused coupling kernels: a (B, D) input is the
    kernels' (B, 1, D) view, one row a sample, on the half kernels (the
    "tile" path) at widths other than the row stream's.  The reference reads
    ``d`` from the example it is initialised with; port modules take their
    widths at construction.  Parameters are drawn from ``generator`` on the
    CPU, in layer order, then moved to ``device`` (``cuda`` unless named;
    raises without a card)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    layers = []
    for i in range(depth):
        flip = bool(i % 2)
        n = d - d // 2 if flip else d // 2  # the transformed half's width
        net = CouplingMLP(d - n, n if additive else 2 * n, hidden=hidden, depth=mlp_depth,
                          generator=gen, device=dev)
        layers += [ActNorm(d, device=dev),
                   AffineCoupling(net, flip=flip, additive=additive, clamp=clamp,
                                  kernel_training=kernel_training)]
    return InvertibleChain(layers, grad_mode=grad_mode)
