"""Memory-frugal backpropagation through invertible layer stacks.

The port of the reference's ``core/autodiff.py``, the paper's central
mechanism: instead of letting autograd store every intermediate activation,
the backward pass rebuilds each layer's input from its output by the layer's
inverse, then differentiates that one layer locally.  Only the network's
output crosses from forward to backward, so the activation memory of a
gradient does not grow with depth.

Two engines:

* :func:`make_chain_apply` - a chain of ``Invertible`` layers (the flow
  networks);
* :func:`make_scan_apply` - a homogeneous stack whose parameters are stacked
  along a leading ``k`` axis (``GlowStepStack``); the scan is a Python loop.

Each takes a ``grad_mode``:

* ``"invertible"`` - the paper's technique: an ``autograd.Function`` whose
  forward runs without grad and saves only the output, and whose backward
  walks the layers in reverse, rebuilding by inversion and taking each
  layer's VJP by ordinary autograd.
* ``"coupled"`` - the same, but a layer's ``fused_bwd(y, gy, gld, cond) ->
  (x, gx, gparams, gcond)`` hook, where it has one, rebuilds and
  differentiates in one pass (one conditioner evaluation per coupling in the
  backward, against two for invert-then-VJP).
* ``"autodiff"`` - plain autograd through the same forward.

Every parameter enters the ``autograd.Function`` as an explicit input, so
autograd hands each its gradient; integer buffers do not.  The forward saves
the output leaves through ``ctx.save_for_backward`` and nothing else.
Gradients of a layer's parameters travel as ``{name: grad}`` dicts keyed by
``layer.named_parameters()`` names.

A layer that holds a reverse walk of its own (the scan stack) also offers it
as ``invertible_bwd``, which the chain takes in ``"invertible"`` mode in place
of invert-then-VJP over the whole layer: differentiating the whole stack's
forward would run it once more (five conditioner evaluations per step instead
of three) or store its activations.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.objectives import nll_loss
from repro_torch.core.types import tree_index, tree_leaves, zero_logdet

GRAD_MODES = ("invertible", "coupled", "autodiff")


def _leaves(v) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v]


def _like(proto, leaves):
    """``leaves`` in the structure of ``proto`` (a tensor or a tuple)."""
    return tuple(leaves) if isinstance(proto, (tuple, list)) else leaves[0]


def _detach(v):
    return _like(v, [u.detach() for u in _leaves(v)])


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


def _cast(g, like):
    return _like(like, [gi.to(v.dtype) for gi, v in zip(_leaves(g), _leaves(like))])


def local_vjp(fwd: Callable, x, params: dict, cond, gy, gld):
    """Differentiate one forward ``fwd(x, cond) -> (y, logdet)`` at ``x``
    against the cotangents ``(gy, gld)``.  ``params`` maps names to the leaf
    tensors ``fwd`` reads.  Returns ``(gx, {name: grad}, gcond)``."""
    with torch.enable_grad():
        xs = [v.detach().requires_grad_(v.is_floating_point()) for v in _leaves(x)]
        c = cond.detach().requires_grad_() if cond is not None and cond.is_floating_point() else None
        y, ld = fwd(_like(x, xs), cond if c is None else c)
        outs, gouts = [], []
        for o, g in zip([*_leaves(y), ld], [*_leaves(gy), gld]):
            if o.requires_grad:
                outs.append(o)
                gouts.append(g.to(o.dtype))
        inputs = [*xs, *params.values(), *([c] if c is not None else [])]
        grads = (torch.autograd.grad(outs, inputs, gouts, allow_unused=True) if outs
                 else [None] * len(inputs))
    gx = [g if g is not None else torch.zeros_like(v) for g, v in zip(grads, xs)]
    gp = dict(zip(params, grads[len(xs): len(xs) + len(params)]))
    gcond = grads[-1] if c is not None else None
    return _like(x, gx), gp, gcond


# ---------------------------------------------------------------------------
# chain engine
# ---------------------------------------------------------------------------


def chain_backward(layers: Sequence, y, gy, gld, cond, use_fused: bool):
    """Reverse pass over a chain from its output side.

    Returns ``(x, gx, gparams, gcond)``: the rebuilt chain input, its
    cotangent, one ``{name: grad}`` dict per layer and the summed cotangent
    of ``cond``.  With ``use_fused`` each layer's ``fused_bwd`` is taken where
    it has one; a layer without it takes its ``invertible_bwd``, else the
    generic step: rebuild by ``inverse``, then the layer's local VJP.
    """
    gld = gld.float()
    gparams: list[dict | None] = [None] * len(layers)
    gcond = None
    with torch.no_grad():
        for k in range(len(layers) - 1, -1, -1):
            layer = layers[k]
            hook = (getattr(layer, "fused_bwd", None) if use_fused else None) or getattr(
                layer, "invertible_bwd", None)
            if hook is not None:
                x, gx, gp, gc = hook(y, gy, gld, cond)
            else:
                x = layer.inverse(y, cond)
                gx, gp, gc = local_vjp(layer, x, dict(layer.named_parameters()), cond, gy, gld)
            x = _detach(x)
            gparams[k] = gp
            gcond = _add(gcond, gc)
            y, gy = x, _cast(gx, x)
    return y, gy, gparams, gcond


class _ChainFn(torch.autograd.Function):
    """The ``invertible`` / ``coupled`` chain: saves only the output.
    ``out`` is a dict the forward fills with the output's structure."""

    @staticmethod
    def forward(ctx, layers, plain, use_fused, out, cond, n_x, *args):
        x = tuple(args[:n_x]) if out["x_is_tuple"] else args[0]
        y, ld = plain(x, cond)
        ctx.save_for_backward(*_leaves(y))
        ctx.layers, ctx.use_fused, ctx.cond = layers, use_fused, cond
        ctx.y_is_tuple = out["y_is_tuple"] = isinstance(y, tuple)
        return (*_leaves(y), ld)

    @staticmethod
    def backward(ctx, *grads):
        y = ctx.saved_tensors
        y = tuple(y) if ctx.y_is_tuple else y[0]
        gy = _like(y, list(grads[:-1]))
        _x, gx, gparams, gcond = chain_backward(ctx.layers, y, gy, grads[-1], ctx.cond,
                                                ctx.use_fused)
        g_flat = [gp.get(name) for layer, gp in zip(ctx.layers, gparams)
                  for name, _ in layer.named_parameters()]
        return (None, None, None, None, gcond, None, *_leaves(gx), *g_flat)


def make_chain_apply(layers: Sequence, grad_mode: str = "invertible") -> Callable:
    """``apply(x, cond=None) -> (y, logdet)`` over a chain of layers, its
    gradient taken by the engine ``grad_mode`` names.  Without grad (serving)
    every mode is the plain composition."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode}")

    def plain(x, cond=None):
        logdet = zero_logdet(x)
        for layer in layers:
            x, ld = layer(x, cond)
            logdet = logdet + ld.to(logdet.dtype)
        return x, logdet

    if grad_mode == "autodiff":
        return plain

    def apply(x, cond=None):
        if not torch.is_grad_enabled():
            return plain(x, cond)
        xs = _leaves(x)
        out = {"x_is_tuple": isinstance(x, tuple)}
        params = [p for layer in layers for p in layer.parameters()]
        *y, ld = _ChainFn.apply(layers, plain, grad_mode == "coupled", out, cond, len(xs), *xs,
                                *params)
        return (tuple(y) if out["y_is_tuple"] else y[0]), ld

    return apply


# ---------------------------------------------------------------------------
# scan engine (stacked parameters)
# ---------------------------------------------------------------------------


def scan_backward(step_bwd: Callable, stacked: dict, y, gy, gld, cond=None):
    """Reverse walk over a stack from its output side.

    ``step_bwd(i, y, gy, gld, cond) -> (x, gx, {name: grad}, gcond)`` takes
    step ``i`` back.  Each step's gradients are written into row ``i`` of
    stacked gradients allocated once (``stacked`` maps each parameter name
    to its ``(k, ...)`` tensor), so no step carries a full-size gradient.
    Returns ``(x, gx, {name: stacked grad}, gcond)``.
    """
    gld = gld.float()
    gstacked = {n: torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                for n, p in stacked.items()}
    k = next(iter(stacked.values())).shape[0]
    gcond = None
    with torch.no_grad():
        for i in range(k - 1, -1, -1):
            x, gx, gp, gc = step_bwd(i, y, gy, gld, cond)
            for name, g in gp.items():
                if g is not None:
                    gstacked[name][i] = g
            gcond = _add(gcond, gc)
            y, gy = x.detach(), gx.to(x.dtype)
    return y, gy, gstacked, gcond


def invertible_step_bwd(module, step_fwd: Callable, step_inv: Callable) -> Callable:
    """The generic ``step_bwd`` of a stack: rebuild step ``i``'s input by
    ``step_inv``, then take ``step_fwd``'s VJP over that step's parameters,
    sliced as detached leaves."""
    def step_bwd(i, y, gy, gld, cond):
        p = tree_index(module, i, detach=True)
        x = step_inv(p, y, cond)
        gx, gp, gc = local_vjp(lambda x_, c_: step_fwd(p, x_, c_), x, dict(tree_leaves(p)),
                               cond, gy, gld)
        return x, gx, gp, gc

    return step_bwd


class _ScanFn(torch.autograd.Function):
    """The ``invertible`` / ``coupled`` stack: saves only the output."""

    @staticmethod
    def forward(ctx, plain, step_bwd, names, cond, x, *params):
        y, ld = plain(x, cond)
        ctx.save_for_backward(y)
        ctx.step_bwd, ctx.cond = step_bwd, cond
        ctx.stacked = dict(zip(names, params))
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        (y,) = ctx.saved_tensors
        _x, gx, gstacked, gcond = scan_backward(ctx.step_bwd, ctx.stacked, y, gy, gld, ctx.cond)
        return (None, None, None, gcond, gx, *gstacked.values())


def make_scan_apply(module, step_fwd: Callable, step_inv: Callable,
                    grad_mode: str = "invertible", step_bwd: Callable | None = None) -> Callable:
    """``apply(x, cond=None) -> (y, logdet)`` over ``module``'s ``k`` stacked
    steps.  ``step_fwd(p, x, cond) -> (y, logdet_i)`` and ``step_inv(p, y,
    cond)`` take one step's parameters ``p`` (a nested dict of slices, as
    ``tree_index`` gives).  ``grad_mode="coupled"`` needs ``step_bwd(i, y,
    gy, gld, cond)``, the fused reversible step."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode}")
    if grad_mode == "coupled" and step_bwd is None:
        raise ValueError("grad_mode='coupled' requires step_bwd")

    def plain(x, cond=None):
        ld = zero_logdet(x)
        for i in range(next(module.parameters()).shape[0]):
            x, ld_i = step_fwd(tree_index(module, i), x, cond)
            ld = ld + ld_i.to(ld.dtype)
        return x, ld

    if grad_mode == "autodiff":
        return plain
    bwd = step_bwd if grad_mode == "coupled" else invertible_step_bwd(module, step_fwd, step_inv)

    def apply(x, cond=None):
        if not torch.is_grad_enabled():
            return plain(x, cond)
        names, params = zip(*module.named_parameters())
        return _ScanFn.apply(plain, bwd, names, cond, x, *params)

    return apply


# ---------------------------------------------------------------------------
# the gradient of a flow's NLL
# ---------------------------------------------------------------------------


def value_and_grad_nll(flow, x, cond=None):
    """``(loss, {name: grad})`` of the standard-normal NLL per dimension of
    ``flow`` at ``x``, whatever engine the flow's ``grad_mode`` selects.
    The gradients are returned, not accumulated into ``.grad``."""
    named = dict(flow.named_parameters())
    loss = nll_loss(flow, x, cond)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: g if g is not None else torch.zeros_like(p)
                           for (n, p), g in zip(named.items(), grads)}
