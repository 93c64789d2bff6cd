"""Data-parallel flow training and batch-sharded flow serving, the port of
the reference's ``dist/flow.py``.

* :func:`dp_value_and_grad_nll` - every rank differentiates the NLL of its
  rows through the flow's memory-frugal engine, and the parameter
  gradients are summed over the data axis: inside the engine's backward
  when the flow was built with ``psum_axis`` equal to that axis (each
  layer's reduction overlapped with the rest of the walk,
  ``core/autodiff.py``), else here, after it.  Either way the loss and
  gradients are the single-process ones up to the order of f32 sums.
* :func:`shard_batch` - this rank's rows of a batch: ``ConditionalFlow``,
  ``serve.FlowServeEngine`` and (chunk by chunk) ``uq.PosteriorEngine`` run
  their rows and gather the outputs.

Mesh-parity invariant the streaming UQ layer builds on: latent noise is
always drawn at the full batch extent from the caller's generator before
:func:`shard_batch` takes a rank's rows (``core.distributions.derive_key``),
so the samples, and any statistics accumulated over them, agree across mesh
shapes.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import (
    BatchSharding,
    batch_sharding,
    data_axis_names,
    data_size,
    entry_index,
    entry_size,
)


def _take(tree, sharding: BatchSharding):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _take(v, sharding) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(v, sharding) for v in tree)
    if not getattr(tree, "shape", None):
        return tree
    return sharding.local(tree)


def shard_batch(batch, mesh):
    """This rank's rows of a batch (a tensor or array, or a dict or tuple of
    them) split on the leading axis over the mesh's data axes.  Leaves whose
    extent does not divide the data axes, and everything on a mesh without
    them, stay whole."""
    if mesh is None or not data_axis_names(mesh) or data_size(mesh) <= 1:
        return batch
    return _take(batch, batch_sharding(mesh))


def gather_batch(out, mesh, full: int):
    """The whole batch of a per-rank output (a tensor or a tuple of them)
    whose leading extent is this rank's rows of ``full``: every rank's rows
    gathered in rank order, so every rank holds all ``full`` rows.  An
    output that already has ``full`` rows (its batch did not split) is
    returned as it is."""
    if mesh is None or data_size(mesh) <= 1:
        return out
    if isinstance(out, (tuple, list)):
        return type(out)(gather_batch(v, mesh, full) for v in out)
    if out.shape[0] == full:
        return out
    group = _data_group(mesh)
    stacked = comm.all_gather(out.contiguous(), group)
    return stacked.reshape(full, *out.shape[1:])


def _data_group(mesh):
    """The group of the combined data axes (``("pod", "data")`` on a
    multi-pod mesh), ranked as :func:`shard_batch` splits the rows."""
    return comm.mesh_group(mesh, data_axis_names(mesh))


def _nll(flow, x, cond, scale: float):
    """Standard-normal NLL per dim, scaled by ``scale`` so the ranks' losses
    sum to the global mean."""
    # imported here: repro_torch.core's conditional flows import this module
    from repro_torch.core.objectives import nll_loss

    return nll_loss(flow, x, cond) * scale


def dp_value_and_grad_nll(flow, mesh, axis="data"):
    """``vg(x, cond=None) -> (loss, {name: grad})``: the data-parallel twin
    of ``core.autodiff.value_and_grad_nll``.

    Every rank passes the whole batch; each takes its rows of ``x`` (and of
    ``cond``) over ``mesh[axis]`` (``axis`` a name, or a tuple of names such
    as a multi-pod mesh's ``("pod", "data")``) and differentiates its own mean NLL scaled
    by ``1 / n_ranks``.  When the flow's ``psum_axis`` is ``axis`` its
    backward sums the gradients; otherwise (plain-autograd flows, or the
    CPU ``"stored"`` coupled strategy) they are summed here.  The loss is
    summed over the ranks.  Integer buffers (permutations, signs) are no
    parameters in the port, so no gradient of theirs needs filling in (the
    reference's ``_densify_float0``)."""
    n = entry_size(mesh, axis)
    sharding = BatchSharding(n, entry_index(mesh, axis))
    vjp_reduces = getattr(flow, "psum_axis", None) == axis
    named = dict(flow.named_parameters())

    def vg(x, cond=None):
        x, cond = _take(x, sharding), _take(cond, sharding)
        with comm.bound(mesh):
            loss = _nll(flow, x, cond, 1.0 / n)
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            grads = {k: g if g is not None else torch.zeros_like(p)
                     for (k, p), g in zip(named.items(), grads)}
            loss = loss.detach()
            reducer = comm.GradReducer(axis)
            if not vjp_reduces:
                reducer.add(grads.values())
            reducer.add([loss])
            reducer.wait()
        return loss, grads

    return vg
