"""Microbatched pipeline parallelism (GPipe) over stage-stacked parameters,
the port of the reference's ``dist/pipeline.py``.

The schedule runs along one axis of the mesh (``"pipe"``, of ``S`` ranks,
one process each); rank ``s`` along it holds stage ``s``'s slice of the
stage-stacked parameters.  On a mesh with other axes (``("pipe", "data")``,
``("data", "pipe")``, ...) each rank runs the schedule with the ranks of its
own pipe group, those that share its coordinates on the other axes, and
every such group computes the same outputs: the schedule is replicated over
the other axes, as the reference's ``shard_map`` with ``in_specs=(P(axis),
P())`` replicates it.  With ``M`` microbatches the schedule runs ``M + S -
1`` ticks: at tick ``t`` stage ``s`` works on microbatch ``t - s`` when there
is one, taking it from the input (stage 0) or from stage ``s - 1``, and
handing its output to stage ``s + 1``; the first and last ticks of each
stage are the bubble.  The forward equals all ``S * L`` blocks applied in
sequence on one device.

It is differentiable.  The hand-off is an ``autograd.Function`` pair: the
receiving side's backward sends the gradient upstream and the sending
side's backward receives it from downstream, the transpose of the forward
hand-off, as the transpose of ``lax.ppermute`` flows upstream in the
reference.  The autograd engine takes the microbatches' backward in
reverse order on every stage, so the two sides meet.  The last stage's
outputs are replicated to every rank by a sum over the axis whose backward
passes each rank's gradient through unchanged: every rank computes the same
loss from the replicated output, so the gradient of the last stage's
outputs is that loss's, taken once.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist import comm


def pipeline_stage_fn(block_apply: Callable, n_layers: int) -> Callable:
    """Lift a single block ``block_apply(p_i, h) -> h`` into a stage over
    ``n_layers`` layer-stacked parameters (a dict of ``(n_layers, ...)``
    tensors), applied in order."""

    def stage(stage_params: dict, h):
        for i in range(n_layers):
            h = block_apply({k: v[i] for k, v in stage_params.items()}, h)
        return h

    return stage


class _Recv(torch.autograd.Function):
    """Receive a microbatch from upstream; backward sends its gradient back.
    The stage's parameters are inputs, so a backward that asks for their
    gradients alone still runs this node (autograd skips a node on no path
    to the tensors asked for); it hands them no gradient."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group, *stage_params):
        ctx.src, ctx.group, ctx.n = src, group, len(stage_params)
        return comm.recv(torch.empty(shape, dtype=dtype, device=anchor.device), src, group)

    @staticmethod
    def backward(ctx, g):
        comm.send(g.contiguous(), ctx.src, ctx.group)
        return (None,) * (5 + ctx.n)


class _Send(torch.autograd.Function):
    """Send a microbatch downstream; backward receives its gradient back.
    Returns a scalar zero that joins the stage's output, so the backward
    reaches it."""

    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype = y.shape, y.dtype
        comm.send(y.detach().contiguous(), dst, group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=_g.device)
        return comm.recv(g, ctx.dst, ctx.group), None, None


class _Replicate(torch.autograd.Function):
    """Sum over the pipe group (each of its ranks gets the last stage's
    outputs); the backward passes the gradient through (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, outs, group):
        out = outs.detach().clone()
        comm.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipe_ranks(mesh, axis: str = "pipe") -> list[int]:
    """The global ranks of this rank's group along ``axis``, in the order of
    their coordinate on it: the ranks that share this rank's coordinates on
    every other axis of the mesh."""
    dim = mesh.mesh_dim_names.index(axis)
    index = list(mesh.get_coordinate())
    index[dim] = slice(None)
    return mesh.mesh.cpu()[tuple(index)].tolist()


def pipeline_forward(stage_fn: Callable, stage_params: dict, x: torch.Tensor, mesh,
                     axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through ``S`` pipeline stages over ``mesh[axis]``, on the
    pipe group of this rank's coordinates on the mesh's other axes.

    ``stage_params``: this rank's stage slice (``stage_fn``'s parameters;
    the reference hands the whole stage-stacked tree to ``shard_map``, which
    gives each device its slice).  ``x``: ``(M, microbatch, ...)``, the same
    on every rank.  Returns the ``(M, microbatch, ...)`` outputs after all
    stages, replicated on every rank; the output's shape and dtype are the
    input's, as in the reference's schedule."""
    ranks = pipe_ranks(mesh, axis)
    n_stages, idx = len(ranks), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = x.shape[0]
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    trained = [v for v in stage_params.values() if v.requires_grad]
    outs = [None] * n_micro
    zeros = []
    for t in range(n_micro + n_stages - 1):
        m = t - idx
        if not 0 <= m < n_micro:
            continue  # this stage's bubble
        h = x[m] if idx == 0 else _Recv.apply(anchor, x.shape[1:], x.dtype, ranks[idx - 1],
                                              group, *trained)
        y = stage_fn(stage_params, h)
        if idx < n_stages - 1:
            zeros.append(_Send.apply(y, ranks[idx + 1], group))
        else:
            outs[m] = y
    last = (torch.stack(outs) if idx == n_stages - 1
            else torch.zeros(x.shape, dtype=x.dtype, device=x.device))
    out = _Replicate.apply(last, group)
    for z in zeros:
        out = out + z
    return out
