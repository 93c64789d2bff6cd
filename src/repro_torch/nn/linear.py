"""Dense layers, the port of the reference's ``nn/linear.py``.

Parameters are drawn on the CPU from an explicit ``torch.Generator`` and laid
out as the reference's: ``w`` is (d_in, d_out), ``b`` (d_out,).  Weights stay
in their own dtype and are cast to x's at each use, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import ParamTree, resolve_device


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = True,
               scale: str | float = "glorot", dtype=torch.float32) -> dict:
    """A dense layer's ``{"w", "b"}``.  ``scale`` is ``"glorot"``, ``"he"``,
    ``"lecun"``, a standard deviation, or ``"zeros"`` (GLOW's zero init, for
    couplings that start as the identity)."""
    if scale == "zeros":
        w = torch.zeros((d_in, d_out), dtype=dtype)
    else:
        std = {"glorot": (2.0 / (d_in + d_out)) ** 0.5, "he": (2.0 / d_in) ** 0.5,
               "lecun": (1.0 / d_in) ** 0.5}.get(scale) if isinstance(scale, str) else float(scale)
        if std is None:
            raise ValueError(f"unknown scale {scale!r}")
        w = std * torch.randn((d_in, d_out), generator=generator, dtype=dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def dense_apply(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; ``params`` is anything indexed like the parameter dict."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


class Dense(ParamTree):
    """One dense layer as a module, on ``device`` (``cuda`` unless named)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 scale: str | float = "glorot", generator: torch.Generator | None = None,
                 device=None):
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        super().__init__(dense_init(gen, d_in, d_out, bias=bias, scale=scale))
        self.to(dev)

    def forward(self, x):
        return dense_apply(self, x)
