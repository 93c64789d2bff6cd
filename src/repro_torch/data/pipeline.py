"""Host-side input pipeline: background prefetch over the step-indexed
synthetic sources; the port's own copy of the reference's
``data/pipeline.py`` (which imports no JAX).

The sources are pure functions of the step, so the prefetcher is a bounded
look-ahead thread: determinism and restartability are kept (seeking is
changing the next step index).  The training loop
(``repro_torch.train.loop._supervised_loop``) wraps ``batch_at`` in one of
these, so step ``N+1``'s batch is built on the host while step ``N`` runs;
the loop's own thread moves it to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

#: queue sentinel: the worker has exited and will produce nothing further
_DONE = object()


class Prefetcher:
    """Wraps ``batch_at(step)`` with a bounded background look-ahead.

    Shutdown contract: ``close()`` always returns with the worker thread
    joined — the worker's ``put`` is stop-aware (it re-checks the stop event
    while the queue is full, so it can never re-enqueue into a drained
    queue and block forever), and the final queue slot is a sentinel.
    ``get()`` after ``close()`` raises instead of blocking on a queue no
    producer will ever fill again.
    """

    def __init__(self, batch_at: Callable[[int], Any], start_step: int = 0,
                 lookahead: int = 2):
        self._batch_at = batch_at
        # +1 slot so the sentinel can always land without blocking the join
        self._q: queue.Queue = queue.Queue(maxsize=max(lookahead, 1) + 1)
        self._next = start_step
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware put: blocks in bounded slices, abandoning the item the
        moment ``close()`` raises the stop flag.  Returns False if dropped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        step = self._next
        try:
            while not self._stop.is_set():
                try:
                    batch = self._batch_at(step)
                except BaseException as e:  # surfaced on the consumer's get()
                    self._put(("error", e))
                    return
                if not self._put(("ok", (step, batch))):
                    return
                step += 1
        finally:
            # best-effort sentinel: tells a consumer the stream ended; the
            # stop-aware put drops it when close() is already draining
            self._put(("done", _DONE))

    def get(self) -> tuple[int, Any]:
        if self._closed:
            raise RuntimeError("Prefetcher.get() after close()")
        kind, payload = self._q.get()
        if kind == "error":
            raise payload
        if payload is _DONE:
            raise RuntimeError("prefetch worker exited; no further batches")
        return payload

    def close(self):
        """Idempotent: stop the worker, drain, and join the thread."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so a worker blocked in put() observes the stop flag promptly
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._thread.join()
