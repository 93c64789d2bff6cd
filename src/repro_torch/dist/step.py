"""The data-parallel training step, the port of the reference's
``dist/step.py``.

One process per rank runs the same step the single-process loop runs, on
its rows of the batch, and the reduction over the ranks is explicit:

* **compression off** - a flow built with ``psum_axis`` sums its parameter
  gradients inside its backward, each layer's all_reduce started as soon as
  the layer is done (the overlapped reduction, ``core/autodiff.py``); any
  other objective's gradients are summed after the backward (the trailing
  reduction);
* **compression on** - each rank compresses its own gradient with its own
  error-feedback residual before any collective, and only the compressed
  payload crosses the wire (``optim/compression.py::compressed_allreduce``):
  no dense gradient is all-reduced, which ``dist/comm.py``'s byte counts
  show.

Gradient accumulation (``cfg.accum_steps`` microbatches per rank) and the
replicated AdamW update (the same bits on every rank) run in the same step.

On a mesh whose ``model`` axis is more than 1, or with the reference's
``fsdp`` storage or ``zero1`` moments, :func:`make_sharded_train_step` is
the step: the parameters and moments are stored as each rank's blocks
(``dist/model.py``), gathered where the step uses them, and each rank
updates its blocks.  Under ``zero1`` the gradient's sum over the data axes
is a reduce-scatter into the moments' blocks, AdamW updates that block of
each parameter, and the updated block is all-gathered back, as the
reference's dry run constrains its gradients to the moments' sharding.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.config import TrainConfig
from repro_torch.dist import comm
from repro_torch.dist.sharding import data_axis_names, data_size
from repro_torch.optim.accum import accumulate_grads
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compression import compressed_allreduce
from repro_torch.optim.schedule import cosine_warmup


def dp_axis(mesh):
    """The mesh's data-parallel axis name(s) for collectives: one name, the
    tuple ``("pod", "data")`` on a multi-pod mesh (``comm.axis_group`` takes
    either), or ``None`` when the mesh has none."""
    names = data_axis_names(mesh)
    if not names:
        return None
    return names if len(names) > 1 else names[0]


def dp_size(mesh) -> int:
    return data_size(mesh)


def is_pure_dp(mesh) -> bool:
    """True when every axis of the mesh but the data axes has extent 1 and
    the data axes more than one rank: parameters replicate, and the
    data-parallel step applies."""
    if mesh is None:
        return False
    n_data = dp_size(mesh)
    return n_data > 1 and n_data == math.prod(int(s) for s in mesh.shape)


def _mean_aux(auxes: list, n_ranks: int, group) -> dict:
    """The microbatches' aux averaged, then its float tensors averaged over
    the ranks; other entries are the first microbatch's."""
    out = {}
    for key, v in (auxes[0] if auxes else {}).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            m = sum(a[key].detach().float() for a in auxes) / len(auxes)
            comm.all_reduce(m, group)
            out[key] = m / n_ranks
        else:
            out[key] = v
    return out


def make_dp_train_step(objective: Callable, module: torch.nn.Module, cfg: TrainConfig, mesh,
                       *, grads_reduced_by_vjp: bool = False, zero1: bool = False) -> Callable:
    """The data-parallel ``(state, local_batch, step) -> (state, metrics)``
    update of ``module``'s parameters (in place) on a pure data-parallel
    mesh.

    ``objective(batch) -> (loss, aux)`` returns the mean loss over the batch
    it is given; each rank evaluates it on its rows, scaled by ``1 /
    n_ranks`` before differentiation, so the losses (and through them the
    gradients) sum to the global mean.  ``grads_reduced_by_vjp`` declares
    that the objective's backward already sums the parameter gradients over
    the data axis (a flow built with that ``psum_axis``); it is ignored when
    compression is on, which needs each rank's own gradient before the wire.

    ``state`` is ``{"opt": AdamW state, "err": residuals}``; the residuals
    (``compression_init(params)``, this rank's own) never cross the wire.
    Metrics: the summed loss, the learning rate, AdamW's global norm and
    clip scale, and the objective's float aux averaged over the ranks.

    ``zero1``: the moments are stored as each rank's blocks by
    ``opt_pspecs(zero1=True)`` and the step is :func:`make_sharded_train_step`
    over a ``ModelSharding(module, mesh, zero1=True)``, which the returned
    function carries as ``.sharding`` (its ``init_opt()`` makes the
    moments); compression raises, as on any mesh where no compressed
    payload would cross the wire alone."""
    axis = dp_axis(mesh)
    n = dp_size(mesh)
    if axis is None or n <= 1:
        raise ValueError("make_dp_train_step needs a mesh with data axes")
    if zero1:
        from repro_torch.dist.model import ModelSharding

        sharding = ModelSharding(module, mesh, zero1=True).shard()
        return make_sharded_train_step(objective, module, cfg, mesh, sharding,
                                       grads_reduced_by_vjp=grads_reduced_by_vjp)
    compression = cfg.grad_compression
    if compression != "none":
        # the backward's dense reduction would put full-precision bytes on
        # the wire before compression ran: take each rank's own gradients
        grads_reduced_by_vjp = False
    n_micro = max(int(cfg.accum_steps), 1)
    group = comm.mesh_group(mesh, axis)
    params = dict(module.named_parameters())

    def step_fn(state, batch, step: int):
        lead = next(v for v in (batch.values() if isinstance(batch, dict) else [batch]))
        if lead.shape[0] % n_micro:
            raise ValueError(f"accum_steps={n_micro} does not divide the per-rank batch "
                             f"{lead.shape[0]}")
        auxes = []

        def value_and_grad(b):
            loss, aux = objective(b)
            auxes.append(aux)
            grads = torch.autograd.grad(loss / n, list(params.values()), allow_unused=True)
            return (loss / n).detach(), {k: g if g is not None else torch.zeros_like(p)
                                         for (k, p), g in zip(params.items(), grads)}

        with comm.bound(mesh):
            loss, grads = accumulate_grads(value_and_grad, batch, n_micro)
            err = state["err"]
            if compression != "none":
                grads, err = compressed_allreduce(grads, err, compression, axis,
                                                  cfg.compression_ratio)
            elif not grads_reduced_by_vjp:
                reducer = comm.GradReducer(axis)
                reducer.add(grads.values())
                reducer.wait()
            loss = loss.clone()
            comm.all_reduce(loss, group)
            aux = _mean_aux(auxes, n, group)
        lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
        opt, om = adamw_update(params, grads, state["opt"], cfg, lr)
        return {"opt": opt, "err": err}, {"loss": loss, "lr": lr, **om, **aux}

    return step_fn


def make_sharded_train_step(objective: Callable, module: torch.nn.Module, cfg: TrainConfig, mesh,
                            sharding, *, grads_reduced_by_vjp: bool = False) -> Callable:
    """The ``(state, local_batch, step) -> (state, metrics)`` update of a
    module laid out on a mesh by ``sharding`` (a ``dist.model.ModelSharding``,
    already sharded; its ``fsdp`` and ``zero1`` options hold).

    Every rank runs the single-device step on its rows (the data axes split
    the batch; the ranks of one ``model`` row hold the same rows): the
    scan-stacked leaves are gathered a step's slice at a time, the others
    whole for the step (``sharding.materialized``).  Each rank keeps its
    block of the gradient, sums it over the data axes (unless the flow's
    backward did, ``grads_reduced_by_vjp``), and updates its blocks of the
    parameters and AdamW moments, the clip taken on the whole gradient's
    norm.  A leaf ``fsdp`` splits over the data axes comes back from the
    backward already summed over them; a ``zero1`` leaf's gradient is
    reduce-scattered into its moment's block, and its updated block
    all-gathered back (``sharding.reduce_grads``, ``update_views``,
    ``regather``).  Compression raises, as in the reference: on such a mesh
    no compressed payload would cross the wire alone."""
    if cfg.grad_compression != "none":
        raise ValueError("grad_compression requires a pure data-parallel mesh (or none) without "
                         "zero1 or fsdp: on any other mesh no compressed payload would cross the "
                         "wire")
    if (sharding.zero1 or sharding.fsdp) and grads_reduced_by_vjp:
        raise ValueError("zero1 and fsdp sum the gradients themselves: a psum_axis objective's "
                         "backward would sum them first")
    axis, n = dp_axis(mesh), dp_size(mesh)
    group = comm.mesh_group(mesh, axis) if axis is not None and n > 1 else None
    n_micro = max(int(cfg.accum_steps), 1)
    params = dict(module.named_parameters())

    def step_fn(state, batch, step: int):
        auxes = []

        def value_and_grad(b):
            loss, aux = objective(b)
            auxes.append(aux)
            grads = torch.autograd.grad(loss / n, list(params.values()), allow_unused=True)
            return (loss / n).detach(), {
                k: sharding.local_grad(k, g) if g is not None else sharding.zero_grad(k)
                for k, g in zip(params, grads)}

        with comm.bound(mesh):
            with sharding.materialized():
                loss, grads = accumulate_grads(value_and_grad, batch, n_micro)
            aux = {}  # as the one-process step: no aux without data axes
            if group is not None:
                if not grads_reduced_by_vjp:
                    grads = sharding.reduce_grads(grads, axis)
                loss = loss.clone()
                comm.all_reduce(loss, group)
                aux = _mean_aux(auxes, n, group)
            gnorm = sharding.grad_norm(grads)
        lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
        opt, om = adamw_update(sharding.update_views(), grads, state["opt"], cfg, lr,
                               grad_norm=gnorm)
        if sharding.zero1_specs:
            with comm.bound(mesh):
                sharding.regather()
        return {"opt": opt, "err": state["err"]}, {"loss": loss, "lr": lr, **om, **aux}

    step_fn.sharding = sharding
    return step_fn
