"""Background prefetch for step-indexed pipelines (overlap data gen with compute).

Port of ``repro.data.prefetch``.  ``close()`` also joins the worker: a
worker left running (blocked on a full queue, or inside a PyTorch op)
when the interpreter exits can abort the process.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable


class Prefetcher:
    """Pulls ``fn(step)`` for consecutive steps on a worker thread."""

    def __init__(self, fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = self._fn(step)
            except Exception as e:  # surface errors to the consumer
                self._put(e)
                return
            if not self._put((step, item)):
                return
            step += 1

    def _put(self, item) -> bool:
        """Put ``item``, waiting for room until ``close()``; False if
        closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
