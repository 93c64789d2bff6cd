"""Feed-forward blocks, the port of the reference's ``nn/mlp.py``: SwiGLU
(llama family) and the GELU MLP (whisper/GPT style).

Weights stay f32 and are cast to x's dtype at each use, as the reference
does.  ``jax.nn.gelu`` defaults to the tanh approximation, so the GELU here
is ``F.gelu(approximate="tanh")``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _normal(generator, shape, std) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator, device=generator.device)


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": _normal(generator, (d_model, d_ff), d_model**-0.5),
        "w_up": _normal(generator, (d_model, d_ff), d_model**-0.5),
        "w_down": _normal(generator, (d_ff, d_model), d_ff**-0.5),
    }


def swiglu_apply(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params["w_down"].to(x.dtype)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int) -> dict:
    dev = generator.device
    return {
        "w_in": _normal(generator, (d_model, d_ff), d_model**-0.5),
        "b_in": torch.zeros(d_ff, device=dev),
        "w_out": _normal(generator, (d_ff, d_model), d_ff**-0.5),
        "b_out": torch.zeros(d_model, device=dev),
    }


def gelu_mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    # the biases gain a row axis, so stacked experts' (E, F) biases broadcast
    # over each expert's (E, N, F) rows as (F,) biases do over any rows
    h = x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype).unsqueeze(-2)
    return F.gelu(h, approximate="tanh") @ params["w_out"].to(x.dtype) + \
        params["b_out"].to(x.dtype).unsqueeze(-2)


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str) -> dict:
    if kind == "swiglu":
        return swiglu_init(generator, d_model, d_ff)
    if kind == "gelu_mlp":
        return gelu_mlp_init(generator, d_model, d_ff)
    raise ValueError(f"unknown ffn kind {kind}")


def ffn_apply(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return swiglu_apply(params, x)
    return gelu_mlp_apply(params, x)
