"""Async host->device field prefetch.

Reference: the synchronous ``updateHydro`` NetCDF read stalls compute
every external step (SURVEY.md SS3.3); the replacement here is a
double-buffered background thread that reads the next time record and
stages it on device while the current external step runs
(BASELINE.json north_star "async host-side prefetch pipeline").

The worker thread does file I/O (h5py/scipy release the GIL for the
bulk reads) and ``jax.device_put``; the consumer gets ready device
arrays with zero read latency on the critical path.  Stall time is
tracked for the observability log (SURVEY.md SS5.5).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import jax


class Prefetcher:
    """Background record reader with a bounded ready-queue."""

    def __init__(self, read_fn: Callable[[], Optional[dict]], depth: int = 2,
                 device_put: bool = True):
        """read_fn: returns the next record dict (host numpy) or None at
        end of series."""
        self._read_fn = read_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device_put = device_put
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.stall_s = 0.0  # cumulative consumer wait
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                rec = self._read_fn()
                if rec is None:
                    self._q.put(None)
                    return
                if self._device_put:
                    rec = {k: (jax.device_put(v) if hasattr(v, "shape")
                               else v) for k, v in rec.items()}
                # put blocks when the queue is full (backpressure)
                while not self._stop.is_set():
                    try:
                        self._q.put(rec, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer
            self._exc = e
            try:
                self._q.put(None, timeout=0.25)
            except queue.Full:
                pass

    def next(self) -> Optional[dict]:
        """Next record (blocks only if the reader is behind)."""
        t0 = time.perf_counter()
        rec = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if rec is None and self._exc is not None:
            raise self._exc
        return rec

    def close(self):
        self._stop.set()
        # drain so the worker can exit a blocked put
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
