"""GLOW invertible 1x1 convolution, LU-parameterised.

``W = P @ L @ (U + diag(sign_s * exp(log_s)))`` with ``P`` a fixed
permutation, ``L`` unit-lower-triangular and ``U`` strictly-upper-triangular.
``log|det W| = sum(log_s)`` is free; the inverse is that of the rounded W
the forward applies (:func:`lu_weight_inv`).

The permutation is stored as ``inv_perm`` under the reference's convention:
``W = (L @ U)[inv_perm]`` (a row permutation).  It and the diagonal signs are
integer buffers, so optimizers never touch them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.types import Invertible, resolve_device


def conv1x1_init(generator: torch.Generator, c: int) -> dict:
    """LU parameters of a random rotation, on the CPU.

    ``torch.linalg.lu`` gives ``Q = P @ L @ U``, so ``(L @ U) = Q[perm]`` with
    ``perm[r]`` the row of the 1 in column ``r`` of ``P``; then
    ``inv_perm = argsort(perm)`` and ``(L @ U)[inv_perm] = Q``, the reference's
    convention (``lax.linalg.lu`` returns ``perm`` directly).
    """
    q, _ = torch.linalg.qr(torch.randn((c, c), generator=generator))
    p, lower, upper = torch.linalg.lu(q)
    perm = torch.argmax(p, dim=0)
    s = torch.diagonal(upper)
    return {
        "inv_perm": torch.argsort(perm).to(torch.int32),
        "l": torch.tril(lower, -1),
        "u": torch.triu(upper, 1),
        "sign_s": torch.sign(s).to(torch.int8),
        "log_s": torch.log(torch.abs(s) + 1e-12),
    }


def lu_factors(lu):
    """Full ``(L, U)`` from the LU parameters (one step's, unstacked)."""
    c = lu["l"].shape[-1]
    eye = torch.eye(c, dtype=lu["l"].dtype, device=lu["l"].device)
    l_full = torch.tril(lu["l"], -1) + eye
    u_full = torch.triu(lu["u"], 1) + torch.diag(
        lu["sign_s"].to(lu["log_s"].dtype) * torch.exp(lu["log_s"])
    )
    return l_full, u_full


def lu_weight(lu, factors=None) -> torch.Tensor:
    """``W = (L @ U)[inv_perm]``; ``factors`` is ``lu_factors(lu)`` when the
    caller has it already."""
    l_full, u_full = factors if factors is not None else lu_factors(lu)
    return (l_full @ u_full)[lu["inv_perm"].long()]


def lu_weight_inv_solves(lu, factors=None) -> torch.Tensor:
    """The reference's ``W^-1 = U^-1 L^-1 P^T`` by two triangular solves:
    with ``B = U^-1 L^-1``, ``W^-1 = B[:, inv_perm]``.  It inverts the exact
    ``L U``, not the rounded product :func:`lu_weight` returns."""
    l_full, u_full = factors if factors is not None else lu_factors(lu)
    eye = torch.eye(l_full.shape[0], dtype=l_full.dtype, device=l_full.device)
    linv = torch.linalg.solve_triangular(l_full, eye, upper=False)
    return torch.linalg.solve_triangular(u_full, linv, upper=True)[:, lu["inv_perm"].long()]


def lu_weight_inv(lu, factors=None) -> torch.Tensor:
    """``W^-1`` of the W that the forward applies (:func:`lu_weight`,
    rounded to its dtype).

    :func:`lu_weight_inv_solves` misses the rounded W by O(C eps) in
    ``W W^-1 - I``, and every reconstruction of the reversible backward
    inherits that; at full depth it dominates the gradient's error
    (``chip_smoke.py`` measures both inverses and the gradients they give
    against a float64 oracle).  One Newton step in float64 against the
    forward's own W, ``X + X (I - W X)``, leaves only the final rounding."""
    factors = factors if factors is not None else lu_factors(lu)
    x = lu_weight_inv_solves(lu, factors).double()
    w = lu_weight(lu, factors).double()
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return (x + x @ (eye - w @ x)).to(factors[0].dtype)


def lu_pullback(lu, factors, gw) -> dict:
    """Map a cotangent ``gW`` of ``W = (L @ U)[inv_perm]`` onto the LU
    parameters: ``gA[inv_perm] = gW`` for ``A = L @ U``, then
    ``gL = gA @ U^T`` and ``gU = L^T @ gA`` masked to their free triangles,
    and ``g_log_s = diag(gU) * sign_s * exp(log_s)``.  Returns ``{"l", "u",
    "log_s"}`` (the logdet's own cotangent on ``log_s`` is the caller's)."""
    l_full, u_full = factors
    ga = torch.zeros_like(l_full)
    ga[lu["inv_perm"].long()] = gw.to(l_full.dtype)
    gl_full = ga @ u_full.T
    gu_full = l_full.T @ ga
    sign = lu["sign_s"].to(lu["log_s"].dtype)
    return {
        "l": torch.tril(gl_full, -1),
        "u": torch.triu(gu_full, 1),
        "log_s": torch.diagonal(gu_full) * sign * torch.exp(lu["log_s"]),
    }


class Conv1x1(Invertible):
    def __init__(self, c: int, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        p = conv1x1_init(gen, c)
        self.register_buffer("inv_perm", p["inv_perm"].to(dev))
        self.l = nn.Parameter(p["l"].to(dev))
        self.u = nn.Parameter(p["u"].to(dev))
        self.register_buffer("sign_s", p["sign_s"].to(dev))
        self.log_s = nn.Parameter(p["log_s"].to(dev))

    def _lu(self) -> dict:
        return {"inv_perm": self.inv_perm, "l": self.l, "u": self.u,
                "sign_s": self.sign_s, "log_s": self.log_s}

    def forward(self, x, cond=None):
        y = x @ lu_weight(self._lu()).to(x.dtype)
        spatial = math.prod(x.shape[1:-1]) if x.ndim > 2 else 1
        ld = spatial * torch.sum(self.log_s).float()
        return y, ld.expand(x.shape[0])

    def inverse(self, y, cond=None):
        return y @ lu_weight_inv(self._lu()).to(y.dtype)

    def fused_bwd(self, y, gy, gld, cond=None):
        """The ``grad_mode="coupled"`` hook: ``(x, gx, {name: grad}, None)``
        from the output side, without the generic step's re-forward:
        ``x = y @ W^-1`` (:func:`lu_weight_inv`), ``gx = gy @ W^T``,
        ``gW = sum x^T gy`` in f32, mapped onto (l, u, log_s) by
        :func:`lu_pullback`; the logdet's cotangent lands on ``log_s``."""
        lu = {k: v.detach() for k, v in self._lu().items()}
        factors = lu_factors(lu)
        x = y @ lu_weight_inv(lu, factors).to(y.dtype)
        gx = (gy @ lu_weight(lu, factors).T.to(gy.dtype)).to(y.dtype)
        c = y.shape[-1]
        gw = x.reshape(-1, c).float().T @ gy.reshape(-1, c).float()
        grads = lu_pullback(lu, factors, gw)
        spatial = math.prod(y.shape[1:-1]) if y.ndim > 2 else 1
        grads["log_s"] = grads["log_s"] + spatial * torch.sum(gld.to(lu["log_s"].dtype))
        return x, gx, grads, None
