"""Run configuration of single-device flow training: the fields of the
reference's ``repro/config.py::TrainConfig`` that the port's ``train_flow``
reads, with the reference's defaults.  There is no ``seed``: the flow
arrives initialised, from the generator its builder was given."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
