"""Gradient accumulation (microbatching), the port of the reference's
``optim/accum.py``.

A step's batch is split into ``n_micro`` sequential microbatches; their
gradients are summed in float32 and divided by ``n_micro``, so the
activation memory is one microbatch's.
"""

from __future__ import annotations

from typing import Callable

import torch


def split_batch(batch, n_micro: int) -> list:
    """``batch`` (a tensor, or a dict of them) cut along axis 0 into
    ``n_micro`` equal microbatches."""
    if isinstance(batch, dict):
        parts = {k: split_batch(v, n_micro) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n_micro)]
    if batch.shape[0] % n_micro:
        raise ValueError(f"accum_steps={n_micro} does not divide the batch {batch.shape[0]}")
    return list(batch.reshape(n_micro, batch.shape[0] // n_micro, *batch.shape[1:]))


def accumulate_grads(value_and_grad: Callable, batch, n_micro: int):
    """``(mean loss, mean gradients)`` over ``n_micro`` microbatches of
    ``batch``.  ``value_and_grad(microbatch) -> (loss, {name: grad})``; with
    ``n_micro <= 1`` it is called once on the whole batch.  The sums run in
    float32 in microbatch order, then divide by ``n_micro``, as the
    reference's scan does."""
    if n_micro <= 1:
        return value_and_grad(batch)
    acc, loss_sum = None, None
    for mb in split_batch(batch, n_micro):
        loss, grads = value_and_grad(mb)
        if acc is None:
            acc = {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for n, g in grads.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=loss.device)
        for n, g in grads.items():
            acc[n] += g.float()
        loss_sum = loss_sum + loss.float()
    return loss_sum / n_micro, {n: a / n_micro for n, a in acc.items()}
