"""Asynchronous checkpointing, the port of the reference's
``train/async_ckpt.py``: the caller hands over the state, which is copied to
the host at once, and keeps stepping while a background thread writes it.

* at most one write in flight (a new save waits for the previous one);
* ``wait()`` drains it and raises the write's error, if any;
* crash safety is ``checkpoint.save``'s (temporary directory, then rename).
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Optional

import torch

from repro_torch.train import checkpoint as ckpt


def host_snapshot(state):
    """A copy of ``state`` on the host: every tensor leaf copied off its
    device (a copy even of a CPU tensor, so later in-place updates of the
    caller's tensors do not reach it)."""
    if isinstance(state, Mapping):
        return {k: host_snapshot(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.completed: list[int] = []

    def save(self, state: Any, step: int):
        """Snapshot to host memory now, write in the background."""
        self.wait()  # one write in flight
        host_state = host_snapshot(state)

        def _write():
            try:
                ckpt.save(host_state, self.ckpt_dir, step, self.keep)
                self.completed.append(step)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
