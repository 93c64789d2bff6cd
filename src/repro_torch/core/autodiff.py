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
  along a leading ``k`` axis (``GlowStepStack``; the LM's superblocks, on a
  pair state ``(x1, x2)`` with a shared differentiable ``extra`` and the
  per-sample aux in the logdet slot); the scan is a Python loop.

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
* ``"remat"`` - (scan engine) gradient checkpointing on each step
  (``torch.utils.checkpoint``, non-reentrant): one carry stored a step, the
  step's internals recomputed in the backward.

Every parameter enters the ``autograd.Function`` as an explicit input, so
autograd hands each its gradient; integer buffers do not.  So does each leaf
of a state that is a tuple and of a ``cond`` that is a nested dict of
tensors (the LM's shared weights): autograd routes gradients only to tensor
inputs.  The forward saves the output leaves through
``ctx.save_for_backward`` and nothing else.
Gradients of a layer's parameters travel as ``{name: grad}`` dicts keyed by
``layer.named_parameters()`` names.

Data parallelism (``psum_axis``, as in the reference): an engine built with
``psum_axis`` names an axis of the mesh that ``dist/comm.py::bound`` makes
current, and its backward sums the parameter gradients over it.  Each
layer's gradients (each step's, in the scan engine) start an asynchronous
``all_reduce`` as soon as they exist, so the collectives run while the walk
goes on (the overlap the reference gets from XLA); all are waited for before
the backward returns.  A chain's ``cond`` gradient stays per rank (``cond``
is batch-aligned, split like ``x``); the scan engine's shared ``cond`` (the
LM's shared weights, replicated) is summed.  ``"autodiff"`` and ``"remat"``
have no custom backward to hook, as in the reference.

A layer that holds a reverse walk of its own (the scan stack) also offers it
as ``invertible_bwd``, which the chain takes in ``"invertible"`` mode in place
of invert-then-VJP over the whole layer: differentiating the whole stack's
forward would run it once more (five conditioner evaluations per step instead
of three) or store its activations.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from repro_torch.core.objectives import nll_loss
from repro_torch.core.types import StackSlices, stack_slices, tree_index, tree_leaves, zero_logdet

CHAIN_MODES = ("invertible", "coupled", "autodiff")
GRAD_MODES = CHAIN_MODES + ("remat",)


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
    if b is None:
        return a
    if isinstance(a, dict):
        return {k: _add(a.get(k), b.get(k)) for k in {**a, **b}}
    return a + b


def _cond_leaves(cond) -> list:
    """The tensors of a ``cond``: none, itself, or a nested dict's floating
    leaves in order."""
    if cond is None:
        return []
    return [v for _, v in tree_leaves(cond)] if isinstance(cond, Mapping) else [cond]


def _cond_like(cond, leaves):
    """``cond`` with its tensors replaced by ``leaves`` (``_cond_leaves``'s
    order)."""
    if not isinstance(cond, Mapping):
        return leaves[0] if leaves else cond
    it = iter(leaves)

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else (next(it) if v.is_floating_point()
                                                           else v) for k, v in tree.items()}

    return walk(cond)


def _cast(g, like):
    return _like(like, [gi.to(v.dtype) for gi, v in zip(_leaves(g), _leaves(like))])


def local_vjp(fwd: Callable, x, params: dict, cond, gy, gld):
    """Differentiate one forward ``fwd(x, cond) -> (y, logdet)`` at ``x``
    against the cotangents ``(gy, gld)``.  ``params`` maps names to the leaf
    tensors ``fwd`` reads.  Returns ``(gx, {name: grad}, gcond)``; for a
    ``cond`` that is a nested dict, ``gcond`` is ``{dotted name: grad}``."""
    with torch.enable_grad():
        xs = [v.detach().requires_grad_(v.is_floating_point()) for v in _leaves(x)]
        cs = [v.detach().requires_grad_() for v in _cond_leaves(cond) if v.is_floating_point()]
        y, ld = fwd(_like(x, xs), _cond_like(cond, cs) if cs else cond)
        outs, gouts = [], []
        for o, g in zip([*_leaves(y), ld], [*_leaves(gy), gld]):
            if o.requires_grad:
                outs.append(o)
                gouts.append(g.to(o.dtype))
        inputs = [*xs, *params.values(), *cs]
        grads = (torch.autograd.grad(outs, inputs, gouts, allow_unused=True) if outs
                 else [None] * len(inputs))
    gx = [g if g is not None else torch.zeros_like(v) for g, v in zip(grads, xs)]
    gp = dict(zip(params, grads[len(xs): len(xs) + len(params)]))
    gc = grads[len(xs) + len(params):]
    if isinstance(cond, Mapping):
        return _like(x, gx), gp, dict(zip((n for n, _ in tree_leaves(cond)), gc))
    return _like(x, gx), gp, gc[0] if gc else None


# ---------------------------------------------------------------------------
# chain engine
# ---------------------------------------------------------------------------


def chain_backward(layers: Sequence, y, gy, gld, cond, use_fused: bool, reducer=None):
    """Reverse pass over a chain from its output side.

    Returns ``(x, gx, gparams, gcond)``: the rebuilt chain input, its
    cotangent, one ``{name: grad}`` dict per layer and the summed cotangent
    of ``cond``.  With ``use_fused`` each layer's ``fused_bwd`` is taken where
    it has one; a layer without it takes its ``invertible_bwd``, else the
    generic step: rebuild by ``inverse``, then the layer's local VJP.
    ``reducer`` (a ``dist.comm.GradReducer``) is handed each layer's
    gradients as soon as the layer is done.
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
            if reducer is not None:
                reducer.add(gp.values())
            gcond = _add(gcond, gc)
            y, gy = x, _cast(gx, x)
    return y, gy, gparams, gcond


def _reducer(psum_axis):
    if psum_axis is None:
        return None
    from repro_torch.dist.comm import GradReducer

    return GradReducer(psum_axis)


class _ChainFn(torch.autograd.Function):
    """The ``invertible`` / ``coupled`` chain: saves only the output.
    ``out`` is a dict the forward fills with the output's structure."""

    @staticmethod
    def forward(ctx, layers, plain, use_fused, out, cond, n_x, *args):
        x = tuple(args[:n_x]) if out["x_is_tuple"] else args[0]
        y, ld = plain(x, cond)
        ctx.save_for_backward(*_leaves(y))
        ctx.layers, ctx.use_fused, ctx.cond = layers, use_fused, cond
        ctx.psum_axis = out["psum_axis"]
        ctx.y_is_tuple = out["y_is_tuple"] = isinstance(y, tuple)
        return (*_leaves(y), ld)

    @staticmethod
    def backward(ctx, *grads):
        y = ctx.saved_tensors
        y = tuple(y) if ctx.y_is_tuple else y[0]
        gy = _like(y, list(grads[:-1]))
        reducer = _reducer(ctx.psum_axis)
        _x, gx, gparams, gcond = chain_backward(ctx.layers, y, gy, grads[-1], ctx.cond,
                                                ctx.use_fused, reducer)
        if reducer is not None:
            reducer.wait()
        g_flat = [gp.get(name) for layer, gp in zip(ctx.layers, gparams)
                  for name, _ in layer.named_parameters()]
        return (None, None, None, None, gcond, None, *_leaves(gx), *g_flat)


def make_chain_apply(layers: Sequence, grad_mode: str = "invertible",
                     psum_axis: str | None = None) -> Callable:
    """``apply(x, cond=None) -> (y, logdet)`` over a chain of layers, its
    gradient taken by the engine ``grad_mode`` names.  Without grad (serving)
    every mode is the plain composition.  ``psum_axis``: the backward sums
    the parameter gradients over that axis of the bound mesh (no effect on
    ``"autodiff"``)."""
    if grad_mode not in CHAIN_MODES:
        raise ValueError(f"grad_mode must be one of {CHAIN_MODES}, got {grad_mode}")

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
        out = {"x_is_tuple": isinstance(x, tuple), "psum_axis": psum_axis}
        params = [p for layer in layers for p in layer.parameters()]
        *y, ld = _ChainFn.apply(layers, plain, grad_mode == "coupled", out, cond, len(xs), *xs,
                                *params)
        return (tuple(y) if out["y_is_tuple"] else y[0]), ld

    return apply


# ---------------------------------------------------------------------------
# scan engine (stacked parameters)
# ---------------------------------------------------------------------------


def scan_backward(step_bwd: Callable, slices: StackSlices, y, gy, gld, cond=None,
                  reducer=None):
    """Reverse walk over a stack from its output side.

    ``step_bwd(i, y, gy, gld, cond) -> (x, gx, {name: grad}, gcond)`` takes
    step ``i`` back; ``y`` is a tensor or a tuple of them, and ``gcond`` a
    tensor, a ``{dotted name: grad}`` dict for a dict ``cond``, or None.
    Each step's gradients are written, by ``slices.put_row``, into row
    ``i`` of gradients shaped like the stack's parameters and allocated once
    (``slices``: the stack's :func:`~repro_torch.core.types.stack_slices`),
    so no step carries a full-size gradient; ``gcond`` is summed over the
    steps.  ``reducer`` (a ``dist.comm.GradReducer``) is handed each step's
    rows as soon as the step is done.  Returns ``(x, gx, {name: stacked
    grad}, gcond)``.
    """
    gld = gld.float()
    gstacked = {n: torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                for n, p in slices.module.named_parameters()}
    gcond = None
    with torch.no_grad():
        for i in range(len(slices) - 1, -1, -1):
            x, gx, gp, gc = step_bwd(i, y, gy, gld, cond)
            for name in gp:
                if gp[name] is not None:
                    slices.put_row(name, gstacked[name], i, gp[name])
            if reducer is not None:
                reducer.add(g[i] for g in gstacked.values())
            gcond = _add(gcond, gc)
            y, gy = _detach(x), _cast(gx, x)
            # a step's gradients are copied: free them before the next step
            # runs, or a step of many units holds two steps' at once
            del x, gx, gp, gc
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
    """The ``invertible`` / ``coupled`` stack: saves only the output.  The
    state's leaves, ``cond``'s tensors and the stacked parameters arrive as
    separate inputs; ``spec`` carries the state's and ``cond``'s structure."""

    @staticmethod
    def forward(ctx, plain, step_bwd, spec, *args):
        n_x, n_c = spec["n_x"], spec["n_cond"]
        x = _like(spec["x"], list(args[:n_x]))
        cond = _cond_like(spec["cond"], list(args[n_x:n_x + n_c]))
        y, ld = plain(x, cond)
        ctx.save_for_backward(*_leaves(y))
        ctx.step_bwd, ctx.cond, ctx.spec = step_bwd, cond, spec
        ctx.psum_axis = spec["psum_axis"]
        return (*_leaves(y), ld)

    @staticmethod
    def backward(ctx, *grads):
        y = _like(ctx.spec["x"], list(ctx.saved_tensors))
        gy = _like(y, list(grads[:-1]))
        reducer = _reducer(ctx.psum_axis)
        _x, gx, gstacked, gcond = scan_backward(ctx.step_bwd, ctx.spec["slices"], y, gy,
                                                grads[-1], ctx.cond, reducer)
        cond = ctx.spec["cond"]
        if isinstance(cond, Mapping):
            gcond = [(gcond or {}).get(n) for n, _ in tree_leaves(cond)]
        else:
            gcond = [gcond] if cond is not None else []
        if reducer is not None:
            # the shared cond (replicated weights) sums like the parameters
            reducer.add(gcond)
            reducer.wait()
        return (None, None, None, *_leaves(gx), *gcond, *gstacked.values())


def make_scan_apply(module, step_fwd: Callable, step_inv: Callable,
                    grad_mode: str = "invertible", step_bwd: Callable | None = None,
                    psum_axis: str | None = None) -> Callable:
    """``apply(x, cond=None) -> (y, logdet)`` over ``module``'s ``k`` stacked
    steps.  ``step_fwd(p, x, cond) -> (y, logdet_i)`` and ``step_inv(p, y,
    cond)`` take one step's parameters ``p`` (a nested dict of slices, as
    ``tree_index`` gives).  ``x`` is a tensor or a tuple of them (the LM's
    pair state, of one structure at every step); ``cond`` is None, a tensor,
    or a nested dict of tensors shared by every step (the LM's shared
    weights), whose gradient is summed over the steps.  ``grad_mode=
    "coupled"`` needs ``step_bwd(i, y, gy, gld, cond)``, the fused
    reversible step; ``"remat"`` checkpoints each step.  ``psum_axis``: as
    in :func:`make_chain_apply`, the backward sums each step's parameter
    gradients and the shared ``cond``'s over that axis of the bound mesh."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, got {grad_mode}")
    if grad_mode == "coupled" and step_bwd is None:
        raise ValueError("grad_mode='coupled' requires step_bwd")

    def run(step, x, cond):
        ld = zero_logdet(x)
        for i in range(len(stack_slices(module))):
            x, ld_i = step(i, x, cond)
            ld = ld + ld_i.to(ld.dtype)
        return x, ld

    def plain(x, cond=None):
        return run(lambda i, x_, c_: step_fwd(tree_index(module, i), x_, c_), x, cond)

    if grad_mode == "autodiff":
        return plain
    if grad_mode == "remat":
        from torch.utils.checkpoint import checkpoint

        def rematted(x, cond=None):
            if not torch.is_grad_enabled():
                return plain(x, cond)
            return run(lambda i, x_, c_: checkpoint(
                lambda x__, c__: step_fwd(tree_index(module, i), x__, c__), x_, c_,
                use_reentrant=False), x, cond)

        return rematted
    bwd = step_bwd if grad_mode == "coupled" else invertible_step_bwd(module, step_fwd, step_inv)

    def apply(x, cond=None):
        if not torch.is_grad_enabled():
            return plain(x, cond)
        params = [p for _, p in module.named_parameters()]
        xs, cs = _leaves(x), _cond_leaves(cond)
        # the state's structure only: holding its tensors would keep them alive
        spec = {"x": (None,) * len(xs) if isinstance(x, tuple) else None, "n_x": len(xs),
                "cond": cond, "n_cond": len(cs), "psum_axis": psum_axis,
                "slices": stack_slices(module)}
        *y, ld = _ScanFn.apply(plain, bwd, spec, *xs, *cs, *params)
        return _like(x, y), ld

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
