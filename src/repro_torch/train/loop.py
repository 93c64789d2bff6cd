"""The supervised training loop on one device, the port of the reference's
``repro/train/loop.py``: checkpoints and restarts, cooperative preemption,
the straggler watchdog, gradient accumulation and an asynchronous input
pipeline, under three front-ends:

* ``train_lm(model, ...)`` - LM training (``Model.train_loss`` through the
  reversible scan engine);
* ``train_flow(flow, ...)`` - flow NLL training (the paper's native path);
* ``train_conditional_flow(model, ...)`` - amortized posterior training of a
  ``ConditionalFlow``.

Each step takes ``data.batch_at(step)``, the loss and its gradient (through
the flow's ``grad_mode`` engine; averaged over ``cfg.accum_steps``
microbatches), the cosine-warmup learning rate of that step, and one AdamW
update, with the reference's arithmetic.  The model's own parameters are the
starting point and the update writes them in place.

With ``cfg.prefetch > 0`` a background thread builds step ``N+1``'s batch on
the host while step ``N`` runs; the loop's thread moves it to the device.
The sources are pure functions of the step index, so this changes nothing in
the result.

Fault-tolerance contract (``tests/test_torch_train_loop.py``): a run killed
at any step and restarted resumes from the latest checkpoint (or, before the
first, from the model as it arrived) and reaches bit for bit the state of an
uninterrupted run, with no duplicate final save.  A SIGTERM (caught from
the main thread only) saves the step just finished and ends the run early,
with ``TrainResult.preempted`` set.  ``cfg.checkpoint_dir`` None keeps no
checkpoints, restarts nothing and leaves SIGTERM alone: a failure or the
signal ends the run as in a bare loop.  A mesh
and gradient compression wait for the distribution slice (ROADMAP.md queue
1, item 7).
"""

from __future__ import annotations

import signal
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.autodiff import value_and_grad_nll
from repro_torch.core.types import resolve_device, to_device
from repro_torch.data.pipeline import Prefetcher
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
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


def _supervised_loop(
    value_and_grad: Callable,
    module: torch.nn.Module,
    data_fn: Callable[[int], object],
    cfg: TrainConfig,
    *,
    device: torch.device,
    injector: Optional[FailureInjector] = None,
) -> TrainResult:
    """Train ``module``'s parameters in place for ``cfg.steps`` steps.
    ``value_and_grad(batch) -> (loss, {name: grad})`` over
    ``module.named_parameters()``; ``data_fn(step)`` is the step's batch on
    the host."""
    params = dict(module.named_parameters())
    # the state a restart returns to when no checkpoint was written yet
    initial = {k: v.detach().clone() for k, v in module.state_dict().items()}
    watchdog = StragglerWatchdog(cfg.step_timeout_s) if cfg.step_timeout_s > 0 else None
    restarts = {"n": 0}
    n_micro = max(int(cfg.accum_steps), 1)

    # cooperative preemption: checkpoint on SIGTERM, then stop cleanly
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # pragma: no cover - signal path
        preempted["flag"] = True

    old_handler = None
    resumable = cfg.checkpoint_dir is not None
    if resumable and threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    def load(values: dict):
        with torch.no_grad():
            for key, v in module.state_dict(keep_vars=True).items():
                v.copy_(values[key])

    def attempt_run(attempt: int) -> TrainResult:
        start = ckpt.latest_step(cfg.checkpoint_dir)
        if start is not None:
            like = {"params": module.state_dict(), "opt": adamw_init(params)}
            state, start = ckpt.restore(like, cfg.checkpoint_dir)
            load(state["params"])
            opt, start_step = state["opt"], start + 1
        else:
            load(initial)
            opt, start_step = adamw_init(params), 0

        prefetch = (Prefetcher(data_fn, start_step, lookahead=cfg.prefetch)
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
                        batch = data_fn(step)
                    loss, grads = accumulate_grads(value_and_grad, to_device(batch, device),
                                                   n_micro)
                    lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
                    opt, _ = adamw_update(params, grads, opt, cfg, lr)
                finally:
                    # the deadline timer dies with the step: a step that
                    # raises would otherwise flag the restarted attempt
                    if watchdog is not None:
                        watchdog.end_step()
                losses.append(float(loss))
                if resumable and (
                        (step + 1) % cfg.checkpoint_every == 0 or preempted["flag"]):
                    ckpt.save({"params": module.state_dict(), "opt": opt}, cfg.checkpoint_dir,
                              step, cfg.keep_checkpoints)
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
            ckpt.save({"params": module.state_dict(), "opt": opt}, cfg.checkpoint_dir, step,
                      cfg.keep_checkpoints)
        return TrainResult(
            params=module.state_dict(), opt_state=opt, final_step=step, losses=losses,
            restarts=restarts["n"],
            flagged_steps=tuple(watchdog.flagged_steps) if watchdog else (),
            preempted=preempted["flag"],
        )

    def on_restart(attempt, exc):
        restarts["n"] = attempt

    try:
        # without checkpoints a failure propagates: no attempt is rerun
        return run_with_restarts(attempt_run, max_restarts=cfg.max_restarts if resumable else 0,
                                 on_restart=on_restart)
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)


# ---------------------------------------------------------------------------
# front-ends
# ---------------------------------------------------------------------------


def train_lm(model, data, cfg: TrainConfig, *, grad_mode: str | None = None, device=None,
             injector=None) -> TrainResult:
    """Train ``model`` (``models.lm.Model``) for ``cfg.steps`` steps on
    ``device`` (``cuda`` unless named; raises without a card): its
    ``train_loss(batch, grad_mode)`` is the objective and
    ``data.batch_at(step)`` yields ``{"tokens", "labels"}`` (a
    ``SyntheticTokens``).  ``grad_mode`` None takes the model's default
    (``invertible`` for a reversible stack).  A model with a front end
    takes its batch's modality features beside them (``frames`` for
    whisper-small, ``patches`` for llava-next-34b; ``models/registry.py::
    batch_like``).  An ``ssm`` or ``hybrid`` model trains through its plain
    scans on either device (``nn/ssm.py::scan_on_kernel``)."""
    dev = resolve_device(device)
    model.to(dev).train()
    objective = objective_value_and_grad(
        model, lambda batch: model.train_loss(batch, grad_mode=grad_mode))
    return _supervised_loop(objective, model, data.batch_at, cfg, device=dev, injector=injector)


def train_flow(flow, data, cfg: TrainConfig, *, device=None, injector=None) -> TrainResult:
    """Train ``flow`` for ``cfg.steps`` steps on ``device`` (``cuda`` unless
    named; raises without a card).  ``data.batch_at(step)`` returns the
    batch, an array or a tensor.  Returns the trained ``state_dict``, the
    optimizer state and each step's loss (before its update)."""
    dev = resolve_device(device)
    flow.to(dev).train()

    def value_and_grad(x):
        return value_and_grad_nll(flow, x.to(dev, torch.float32))

    return _supervised_loop(value_and_grad, flow, data.batch_at, cfg, device=dev,
                            injector=injector)


def train_conditional_flow(model, data, cfg: TrainConfig, *, device=None,
                           injector=None) -> TrainResult:
    """Amortized posterior training of ``model``, a ``ConditionalFlow``, on
    ``device`` (``cuda`` unless named; raises without a card): its
    ``train_loss`` hook is the objective and ``data.batch_at(step)`` yields
    ``{"theta", "y"}`` joint draws.  The summary network and the flow train
    together: the flow's engine hands the summary output its cotangent."""
    dev = resolve_device(device)
    model.to(dev).train()
    return _supervised_loop(objective_value_and_grad(model, model.train_loss), model,
                            data.batch_at, cfg, device=dev, injector=injector)


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
