"""The supervised training loop, the port of the reference's
``repro/train/loop.py``: checkpoints and restarts, cooperative preemption,
the straggler watchdog, gradient accumulation, gradient compression and an
asynchronous input pipeline, under four front-ends:

* ``train_lm(model, ...)`` - LM training (``Model.train_loss`` through the
  reversible scan engine);
* ``train_flow(flow, ...)`` - flow NLL training (the paper's native path);
* ``train_conditional_flow(model, ...)`` - amortized posterior training of a
  ``ConditionalFlow``;
* ``train_pipeline(...)`` - opt-in GPipe depth parallelism over a mesh's
  ``pipe`` axis, replicated over its other axes.

Each step takes ``data.batch_at(step)``, the loss and its gradient (through
the flow's ``grad_mode`` engine; averaged over ``cfg.accum_steps``
microbatches), the cosine-warmup learning rate of that step, and one AdamW
update, with the reference's arithmetic.  The model's own parameters are the
starting point and the update writes them in place.

With ``cfg.prefetch > 0`` a background thread builds step ``N+1``'s batch on
the host while step ``N`` runs; the loop's thread moves it to the device.
The sources are pure functions of the step index, so this changes nothing in
the result.

All take an optional ``mesh`` (``launch/mesh.py``, one process per rank).  On
a pure data-parallel mesh the step is ``dist/step.py``'s: each rank takes its
rows of the whole batch ``data.batch_at(step)`` (so prefetch means the same
on every rank), and the gradient sum is overlapped into the flow's backward
(``psum_axis``), trailing, or error-feedback compressed before the wire
(``cfg.grad_compression``).  Without a mesh, compression runs locally
(``compress_grads``), nothing crossing a wire.  On a mesh whose ``model``
axis is more than 1 the step is ``dist/step.py::make_sharded_train_step``:
each rank stores its block of every parameter by the reference's
``params_pspecs`` and of every AdamW moment by ``opt_pspecs``
(``dist/model.py``; 1-D leaves and the step counter replicate), a step
gathers the leaves where they are used (a GLOW stack's or an LM stack's a
step's slice at a time, the rest whole for the step), runs the
single-device computation on its rows, sums its block of the gradient over
the data axes and updates its blocks.  Compression there raises
``ValueError``, as in the reference.  Its checkpoints hold each leaf whole
(every rank gathers, rank 0 writes), so a restart may lay the state out on
another ``(d, m)``; at the end the module's leaves are gathered whole again
and ``TrainResult.shard_bytes`` gives this rank's stored bytes beside one
process's (``opt_state`` holds this rank's blocks).

Fault-tolerance contract (``tests/test_torch_train_loop.py``): a run killed
at any step and restarted resumes from the latest checkpoint (or, before the
first, from the model as it arrived) and reaches bit for bit the state of an
uninterrupted run, with no duplicate final save.  A SIGTERM (caught from
the main thread only) saves the step just finished and ends the run early,
with ``TrainResult.preempted`` set.  ``cfg.checkpoint_dir`` None keeps no
checkpoints, restarts nothing and leaves SIGTERM alone: a failure or the
signal ends the run as in a bare loop.  On a mesh rank 0 writes the
checkpoints, with the mesh's shape, and every rank's compression residuals
in one ``(n_ranks, ...)`` leaf each; a restart on another data-parallel width
warns and re-zeros the residuals (an optimization detail, not model state).
"""

from __future__ import annotations

import contextlib
import signal
import threading
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.objectives import nll_loss
from repro_torch.core.types import ParamTree, resolve_device, to_device
from repro_torch.data.pipeline import Prefetcher
from repro_torch.dist import comm
from repro_torch.dist.flow import shard_batch
from repro_torch.dist.model import ModelSharding
from repro_torch.dist.sharding import data_index, model_size
from repro_torch.dist.step import (
    dp_axis,
    dp_size,
    is_pure_dp,
    make_dp_train_step,
    make_sharded_train_step,
)
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    compress_grads,
    compression_init,
    cosine_warmup,
)
from repro_torch.optim.accum import accumulate_grads
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FailureInjector, StragglerWatchdog, run_with_restarts


@dataclass
class TrainResult:
    params: dict
    opt_state: dict
    final_step: int
    losses: list = field(default_factory=list)
    restarts: int = 0
    flagged_steps: tuple = ()
    preempted: bool = False  # a SIGTERM ended the run before cfg.steps
    err_state: dict = field(default_factory=dict)  # this rank's compression residuals
    # on a model-sharded mesh: this rank's stored parameter and moment bytes
    # beside one process's ({"params", "params_whole", "moments", "moments_whole"})
    shard_bytes: dict = field(default_factory=dict)


def _dp_fast_path(mesh, cfg: TrainConfig) -> bool:
    """True when the mesh runs the data-parallel step (``dist/step.py``)."""
    if mesh is None:
        return False
    if not is_pure_dp(mesh):
        if cfg.grad_compression != "none":
            raise ValueError("grad_compression requires a pure data-parallel mesh (or none): "
                             "on any other mesh no compressed payload would cross the wire")
        return False
    return True


def _err_shards(mesh, cfg: TrainConfig) -> int | None:
    """The leading shard axis of the residuals in a checkpoint (None =
    one process's)."""
    if cfg.grad_compression == "none":
        return None
    return dp_size(mesh) if _dp_fast_path(mesh, cfg) else None


def _init_err(params: dict, cfg: TrainConfig) -> dict:
    """This process's zero residuals; empty without compression, which
    keeps the state and checkpoints free of dead zero trees."""
    if cfg.grad_compression == "none":
        return {}
    return {n: e for n, e in compression_init(params).items() if e is not None}


def _make_step(objective: Callable, module, cfg: TrainConfig, mesh=None, vjp_psum_axis=None,
               sharding=None):
    """``(state, batch, step) -> (state, metrics)``: the data-parallel step
    on a pure data-parallel mesh (:func:`repro_torch.dist.step.
    make_dp_train_step`), the model-sharded step where ``sharding`` lays the
    module out (:func:`repro_torch.dist.step.make_sharded_train_step`), else
    the one-process step with local compression.  ``vjp_psum_axis``: the
    objective's backward already sums the parameter gradients over that
    mesh axis (a flow built with ``psum_axis``)."""
    if sharding is not None:
        return make_sharded_train_step(objective, module, cfg, mesh, sharding,
                                       grads_reduced_by_vjp=vjp_psum_axis is not None
                                       and vjp_psum_axis == dp_axis(mesh))
    if _dp_fast_path(mesh, cfg):
        if cfg.grad_compression != "none" and vjp_psum_axis is not None:
            raise ValueError("grad_compression with a psum_axis flow: its backward would "
                             "all-reduce dense gradients before compression; build the flow "
                             "without psum_axis to train compressed")
        return make_dp_train_step(objective, module, cfg, mesh,
                                  grads_reduced_by_vjp=vjp_psum_axis is not None
                                  and vjp_psum_axis == dp_axis(mesh))
    params = dict(module.named_parameters())
    value_and_grad = objective_value_and_grad(module, objective)
    n_micro = max(int(cfg.accum_steps), 1)

    def step_fn(state, batch, step: int):
        # a mesh of one rank binds its axes (a psum_axis flow reduces over 1)
        with comm.bound(mesh) if mesh is not None else contextlib.nullcontext():
            loss, grads = accumulate_grads(value_and_grad, batch, n_micro)
        # local error-feedback compression: nothing crosses a wire here
        grads, err = compress_grads(grads, state["err"], cfg.grad_compression,
                                    cfg.compression_ratio)
        lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
        opt, om = adamw_update(params, grads, state["opt"], cfg, lr)
        return {"opt": opt, "err": err}, {"loss": loss, "lr": lr, **om}

    return step_fn


def _save_err(err: dict, mesh, cfg: TrainConfig) -> dict:
    """The residuals as a checkpoint holds them: every rank's in one
    ``(n_ranks, ...)`` leaf on a data-parallel mesh (a collective: every
    rank calls it), else this process's."""
    if _err_shards(mesh, cfg) is None:
        return err
    group = comm.mesh_group(mesh, dp_axis(mesh))
    return {n: comm.all_gather(e, group) for n, e in err.items()}


def _restore_state(module, params, cfg: TrainConfig, mesh, sharding=None):
    """``(module state, opt, err, step)`` of the latest checkpoint.  An
    elastic restart onto another data-parallel width changes the residuals'
    shapes: they are re-zeroed, with a warning, instead of failing.  With
    ``sharding`` the checkpoint's whole leaves are read and the module state
    is returned whole, the moments as this rank's blocks."""
    shards = _err_shards(mesh, cfg)
    err_like = {}
    if cfg.grad_compression != "none":
        err_like = {n: e for n, e in compression_init(params, shards).items() if e is not None}
    if sharding is not None:
        whole = sharding.whole_like(module.state_dict())
        like = {"params": whole, "opt": adamw_init({n: whole[n] for n in params}), "err": {}}
        state, step = ckpt.restore(like, cfg.checkpoint_dir, mesh=mesh)
        return state["params"], sharding.local_opt(state["opt"]), {}, step
    like = {"params": module.state_dict(), "opt": adamw_init(params), "err": err_like}
    try:
        state, step = ckpt.restore(like, cfg.checkpoint_dir, mesh=mesh)
        err = state["err"]
        if shards is not None:
            err = {n: e[data_index(mesh)].clone() for n, e in err.items()}
    except (ValueError, KeyError) as e:
        if "err/" not in str(e):
            raise
        state, step = ckpt.restore({"params": like["params"], "opt": like["opt"]},
                                   cfg.checkpoint_dir, mesh=mesh)
        warnings.warn("error-feedback accumulator shape changed across restart (elastic "
                      "data-parallel resize); residuals re-zeroed", stacklevel=2)
        err = _init_err(params, cfg)
    return state["params"], state["opt"], err, step


def _supervised_loop(
    objective: Callable,
    module: torch.nn.Module,
    data_fn: Callable[[int], object],
    cfg: TrainConfig,
    *,
    device: torch.device,
    mesh=None,
    injector: Optional[FailureInjector] = None,
    vjp_psum_axis: str | None = None,
    step_fn: Callable | None = None,
    shard_rows: bool = True,
) -> TrainResult:
    """Train ``module``'s parameters in place for ``cfg.steps`` steps.
    ``objective(batch) -> (loss, aux)`` is the mean loss over the batch it
    is given; ``data_fn(step)`` is the step's whole batch on the host, of
    which each rank takes its rows over the mesh's data axes unless
    ``shard_rows`` is off (every rank then takes the whole batch).
    ``step_fn`` (``train_pipeline``'s) replaces the step :func:`_make_step`
    builds."""
    params = dict(module.named_parameters())
    # the state a restart returns to when no checkpoint was written yet
    initial = {k: v.detach().clone() for k, v in module.state_dict().items()}
    sharding = None
    if step_fn is None and model_size(mesh) > 1:
        _dp_fast_path(mesh, cfg)  # compression on a model-sharded mesh raises
        sharding = ModelSharding(module, mesh).shard()
    step_fn = step_fn or _make_step(objective, module, cfg, mesh, vjp_psum_axis, sharding)
    watchdog = StragglerWatchdog(cfg.step_timeout_s) if cfg.step_timeout_s > 0 else None
    restarts = {"n": 0}

    def batch_fn(step: int):
        # the whole batch, then this rank's rows: built in the prefetch
        # thread, the same on every rank
        return shard_batch(data_fn(step), mesh) if shard_rows else data_fn(step)

    # cooperative preemption: checkpoint on SIGTERM, then stop cleanly
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # pragma: no cover - signal path
        preempted["flag"] = True

    old_handler = None
    resumable = cfg.checkpoint_dir is not None
    if resumable and threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    def load(values: dict):
        # whole values; a model-sharded module takes its blocks of them
        if sharding is not None:
            values = sharding.local_tree(values)
        with torch.no_grad():
            for key, v in module.state_dict(keep_vars=True).items():
                v.copy_(values[key])

    def save(state, step):
        on_mesh = {} if mesh is None else {"mesh": mesh}
        if sharding is not None:
            # each leaf whole: every rank gathers, rank 0 writes
            whole = {"params": sharding.whole_tree(module.state_dict()),
                     "opt": sharding.whole_opt(state["opt"]), "err": {}}
        else:
            whole = {"params": module.state_dict(), "opt": state["opt"],
                     "err": _save_err(state["err"], mesh, cfg)}
        ckpt.save(whole, cfg.checkpoint_dir, step, cfg.keep_checkpoints, **on_mesh)

    def attempt_run(attempt: int) -> TrainResult:
        start = ckpt.latest_step(cfg.checkpoint_dir)
        if start is not None:
            values, opt, err, start = _restore_state(module, params, cfg, mesh, sharding)
            load(values)
            state, start_step = {"opt": opt, "err": err}, start + 1
        else:
            load(initial)
            state, start_step = {"opt": adamw_init(params), "err": _init_err(params, cfg)}, 0

        prefetch = (Prefetcher(batch_fn, start_step, lookahead=cfg.prefetch)
                    if cfg.prefetch > 0 else None)
        losses = []
        step = start_step
        saved_at = None
        try:
            for step in range(start_step, cfg.steps):
                if watchdog is not None:
                    watchdog.start_step(step)
                try:
                    if injector is not None:
                        injector.maybe_fail(step)
                    if prefetch is not None:
                        got_step, batch = prefetch.get()
                        if got_step != step:  # pragma: no cover - invariant
                            raise RuntimeError(f"prefetch out of order: wanted {step}, "
                                               f"got {got_step}")
                    else:
                        batch = batch_fn(step)
                    state, metrics = step_fn(state, to_device(batch, device), step)
                finally:
                    # the deadline timer dies with the step: a step that
                    # raises would otherwise flag the restarted attempt
                    if watchdog is not None:
                        watchdog.end_step()
                losses.append(float(metrics["loss"]))
                if resumable and (
                        (step + 1) % cfg.checkpoint_every == 0 or preempted["flag"]):
                    save(state, step)
                    saved_at = step
                if preempted["flag"]:
                    break
            else:
                step = cfg.steps - 1
        finally:
            if prefetch is not None:
                prefetch.close()
        if resumable and saved_at != step:
            # no second save of a step the loop has just saved
            save(state, step)
        return TrainResult(
            params=module.state_dict(), opt_state=state["opt"], final_step=step,
            losses=losses, restarts=restarts["n"],
            flagged_steps=tuple(watchdog.flagged_steps) if watchdog else (),
            preempted=preempted["flag"], err_state=state["err"],
            shard_bytes={} if sharding is None else sharding.resident_bytes(state["opt"]),
        )

    def on_restart(attempt, exc):
        restarts["n"] = attempt

    try:
        # without checkpoints a failure propagates: no attempt is rerun
        result = run_with_restarts(attempt_run,
                                   max_restarts=cfg.max_restarts if resumable else 0,
                                   on_restart=on_restart)
        if sharding is not None:
            # the module whole again for its caller (a collective: on the
            # success path only, where every rank gets here)
            sharding.unshard()
            result.params = module.state_dict()
        return result
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)


# ---------------------------------------------------------------------------
# front-ends
# ---------------------------------------------------------------------------


def train_lm(model, data, cfg: TrainConfig, *, grad_mode: str | None = None, device=None,
             mesh=None, injector=None) -> TrainResult:
    """Train ``model`` (``models.lm.Model``) for ``cfg.steps`` steps on
    ``device`` (``cuda`` unless named; raises without a card): its
    ``train_loss(batch, grad_mode)`` is the objective and
    ``data.batch_at(step)`` yields ``{"tokens", "labels"}`` (a
    ``SyntheticTokens``).  ``grad_mode`` None takes the model's default
    (``invertible`` for a reversible stack).  A model with a front end
    takes its batch's modality features beside them (``frames`` for
    whisper-small, ``patches`` for llava-next-34b; ``models/registry.py::
    batch_like``).  An ``ssm`` or ``hybrid`` model trains through its plain
    scans on either device (``nn/ssm.py::scan_on_kernel``).  ``mesh``: a
    pure data-parallel mesh splits each batch's sequences over the ranks
    (an MoE's capacity is per sequence, so routing does not change)."""
    dev = resolve_device(device)
    model.to(dev).train()
    return _supervised_loop(lambda batch: model.train_loss(batch, grad_mode=grad_mode), model,
                            data.batch_at, cfg, device=dev, mesh=mesh, injector=injector)


def train_flow(flow, data, cfg: TrainConfig, *, device=None, mesh=None,
               injector=None) -> TrainResult:
    """Train ``flow`` for ``cfg.steps`` steps on ``device`` (``cuda`` unless
    named; raises without a card).  ``data.batch_at(step)`` returns the
    batch, an array or a tensor.  Returns the trained ``state_dict``, the
    optimizer state and each step's loss (before its update).

    On a data-parallel ``mesh`` a flow built with ``psum_axis`` equal to the
    mesh's data axis sums its gradients inside its backward (the overlapped
    reduction); the step then skips its own."""
    dev = resolve_device(device)
    flow.to(dev).train()

    def objective(x):
        return nll_loss(flow, x.to(dev, torch.float32)), {}

    return _supervised_loop(objective, flow, data.batch_at, cfg, device=dev, mesh=mesh,
                            injector=injector, vjp_psum_axis=getattr(flow, "psum_axis", None))


def train_conditional_flow(model, data, cfg: TrainConfig, *, device=None, mesh=None,
                           injector=None) -> TrainResult:
    """Amortized posterior training of ``model``, a ``ConditionalFlow``, on
    ``device`` (``cuda`` unless named; raises without a card): its
    ``train_loss`` hook is the objective and ``data.batch_at(step)`` yields
    ``{"theta", "y"}`` joint draws.  The summary network and the flow train
    together: the flow's engine hands the summary output its cotangent."""
    dev = resolve_device(device)
    model.to(dev).train()
    return _supervised_loop(model.train_loss, model, data.batch_at, cfg, device=dev, mesh=mesh,
                            injector=injector)


def train_pipeline(block_apply: Callable, init_fn: Callable, data, cfg: TrainConfig, *, mesh,
                   loss_head: Callable, n_layers_per_stage: int, device=None,
                   injector=None) -> TrainResult:
    """Opt-in GPipe depth parallelism (``dist/pipeline.py``) under the
    supervised loop's contract.

    ``init_fn()`` returns the parameters as a dict of tensors with a
    ``"stages"`` entry whose leaves are stage-stacked ``(S,
    n_layers_per_stage, ...)`` for the mesh's ``cfg.pipeline_axis`` (extent
    ``S``); ``block_apply(p, h) -> h`` is one block; ``loss_head(params, h,
    batch) -> scalar`` reads the pipeline's output (``params`` the same tree
    of the trained tensors).  Each step cuts the batch ``{"x", ...}`` into
    ``cfg.pipeline_microbatches`` microbatches, streams them through the
    stages and differentiates through the schedule.

    Every rank holds the whole tree (replicated, so the loop's AdamW and
    checkpoints are the one-process ones); stage ``s`` reads only its slice
    ``stages[s]``, so its gradient has only that row, and the rows are
    summed over the pipe group before the update.  On a mesh with other
    axes (a ``data`` axis beside ``pipe``) every pipe group takes the whole
    batch, as the reference's ``shard_map`` hands it to each with ``P()``:
    the groups compute the same loss, gradients and update, so the
    parameters stay bitwise equal across them with no collective over the
    other axes.  Returns the rank's ``TrainResult``, the same on every
    rank."""
    from repro_torch.dist.pipeline import pipeline_forward, pipeline_stage_fn

    dev = resolve_device(device)
    n_micro = cfg.pipeline_microbatches
    if n_micro <= 0:
        raise ValueError("train_pipeline needs cfg.pipeline_microbatches > 0")
    if mesh is None or cfg.pipeline_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"train_pipeline needs a mesh with a {cfg.pipeline_axis!r} axis")
    if cfg.grad_compression != "none":
        raise ValueError("grad_compression requires a pure data-parallel mesh (or none): "
                         "train_pipeline sums its stage gradients uncompressed")
    module = ParamTree(init_fn()).to(dev).train()
    stage = pipeline_stage_fn(block_apply, n_layers_per_stage)
    idx = mesh.get_local_rank(cfg.pipeline_axis)
    group = mesh.get_group(cfg.pipeline_axis)

    def tree(mod):
        return {k: tree(v) for k, v in mod.named_children()} | dict(mod.named_parameters(
            recurse=False)) | dict(mod.named_buffers(recurse=False))

    def objective(batch):
        x = batch["x"]
        if x.shape[0] % n_micro:
            raise ValueError(f"pipeline_microbatches={n_micro} does not divide the batch "
                             f"{x.shape[0]}")
        params = tree(module)
        xm = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        h = pipeline_forward(stage, {k: v[idx] for k, v in params["stages"].items()}, xm,
                             mesh, axis=cfg.pipeline_axis)
        return loss_head(params, h.reshape(x.shape[0], *h.shape[2:]), batch), {}

    params = dict(module.named_parameters())
    value_and_grad = objective_value_and_grad(module, objective)
    n_acc = max(int(cfg.accum_steps), 1)

    def step_fn(state, batch, step: int):
        loss, grads = accumulate_grads(value_and_grad, batch, n_acc)
        # each stage's gradient lives in its own row: the sum over the pipe
        # group is the whole stage-stacked gradient on every rank
        for name, g in grads.items():
            if name.startswith("stages."):
                comm.all_reduce(g, group)
        lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
        opt, om = adamw_update(params, grads, state["opt"], cfg, lr)
        return {"opt": opt, "err": state["err"]}, {"loss": loss, "lr": lr, **om}

    return _supervised_loop(objective, module, data.batch_at, cfg, device=dev, mesh=mesh,
                            injector=injector, step_fn=step_fn, shard_rows=False)


def objective_value_and_grad(module, objective: Callable) -> Callable:
    """``batch -> (loss, {name: grad})`` over ``module.named_parameters()``
    for ``objective(batch) -> (loss, aux)`` (a ``ConditionalFlow``'s
    ``train_loss``): the loop's step before its update.  Gradients are
    returned, not accumulated into ``.grad``."""
    named = dict(module.named_parameters())

    def value_and_grad(batch):
        loss, _aux = objective(batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return loss.detach(), {n: g if g is not None else torch.zeros_like(p)
                               for (n, p), g in zip(named.items(), grads)}

    return value_and_grad
