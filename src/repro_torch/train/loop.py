"""Flow training on one device: ``train_flow``, the port of the reference's
``repro/train/loop.py::train_flow`` over its supervised loop.

Each step takes ``data.batch_at(step)``, the NLL and its gradient through the
flow's ``grad_mode`` engine (``core/autodiff.py::value_and_grad_nll``), the
cosine-warmup learning rate of that step, and one AdamW update, with the
reference's arithmetic.  The flow's own parameters are the starting point;
the update writes them in place.  Checkpoints, restarts, prefetching, the
straggler watchdog, a mesh, gradient compression and accumulation are not
ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.autodiff import value_and_grad_nll
from repro_torch.core.types import resolve_device
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup


@dataclass
class TrainResult:
    params: dict
    opt_state: dict
    final_step: int
    losses: list = field(default_factory=list)


def train_flow(flow, data, cfg: TrainConfig, *, device=None) -> TrainResult:
    """Train ``flow`` for ``cfg.steps`` steps on ``device`` (``cuda`` unless
    named; raises without a card).  ``data.batch_at(step)`` returns the
    batch, an array or a tensor.  Returns the trained ``state_dict``, the
    optimizer state and each step's loss (before its update)."""
    dev = resolve_device(device)
    flow.to(dev).train()
    params = dict(flow.named_parameters())
    opt = adamw_init(params)
    losses = []
    step = -1
    for step in range(cfg.steps):
        x = torch.as_tensor(data.batch_at(step)).to(dev, torch.float32)
        loss, grads = value_and_grad_nll(flow, x)
        lr = cosine_warmup(step, cfg.lr, cfg.warmup_steps, cfg.steps)
        opt, _ = adamw_update(params, grads, opt, cfg, lr)
        losses.append(float(loss))
    return TrainResult(params=flow.state_dict(), opt_state=opt, final_step=step, losses=losses)
