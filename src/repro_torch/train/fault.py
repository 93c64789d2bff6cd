"""Fault-tolerance machinery: failure injection, the straggler watchdog and
restart-from-checkpoint supervision; the port's own copy of the reference's
``train/fault.py`` (which imports no JAX).

On a cluster the job scheduler drives the restart; here the supervisor
reproduces its control flow in-process so it can be tested: a failing step
raises, the supervisor restores the latest checkpoint and resumes, and the
training result must be unaffected (``tests/test_torch_train_loop.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class FailureInjector:
    """Raises ``SimulatedFailure`` the first time each listed step runs."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.pending = set(fail_at)

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class StragglerWatchdog:
    """Per-step deadline monitor.

    On a pod, a straggling host is detected by the controller when a step
    exceeds ``deadline_s``; the mitigation is re-slicing around the slow
    host.  Here we record flags (and optionally raise) so the supervisor
    loop and the tests can observe detection.
    """

    deadline_s: float
    raise_on_flag: bool = False
    flagged_steps: list = field(default_factory=list)
    _timer: Optional[threading.Timer] = None
    _step: int = -1

    def start_step(self, step: int):
        self.cancel()
        self._step = step
        self._timer = threading.Timer(self.deadline_s, self._flag)
        self._timer.daemon = True
        self._timer.start()

    def _flag(self):
        self.flagged_steps.append(self._step)

    def end_step(self):
        self.cancel()

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def run_with_restarts(
    run: Callable[[int], "object"],
    *,
    max_restarts: int,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
):
    """Supervise ``run(attempt)``; restart on exception up to ``max_restarts``."""
    attempt = 0
    while True:
        try:
            return run(attempt)
        except (SimulatedFailure, RuntimeError) as e:  # pragma: no branch
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            time.sleep(0.01)
