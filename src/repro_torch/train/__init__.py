"""Training, the port of the reference's ``repro.train``: the supervised
loop and its front ends (``loop``), checkpoints (``checkpoint``,
``async_ckpt``) and fault tolerance (``fault``)."""

from repro_torch.train.checkpoint import latest_step, restore, save
from repro_torch.train.fault import FailureInjector, StragglerWatchdog
from repro_torch.train.loop import (
    TrainResult,
    train_conditional_flow,
    train_flow,
    train_lm,
)

__all__ = [
    "FailureInjector",
    "StragglerWatchdog",
    "TrainResult",
    "latest_step",
    "restore",
    "save",
    "train_conditional_flow",
    "train_flow",
    "train_lm",
]
