"""The benchmark's receiver: a duck-typed source (``id``,
``get_sample_rate()``, ``block_size``, ``start()``, ``read_block(timeout)``)
that hands the runtime blocks of a looped uint8 wire.

Pacing, set for each phase of a run:

* ``warm``: the next of ``warm_left`` blocks at once, then nothing;
* ``realtime``: block k of the window is released at
  t0 + (k+1)·block/fs, when its last sample would have left the receiver.
  A read waits at most its ``timeout``, as a real receiver's does, and
  finds a late block waiting; the generator never slows down.  ``late``
  keeps, per block, how long after its release the runtime read it;
* ``saturate``: the next block at once, until ``stop_at``.

Every block handed over is recorded with its loop index and the time it
was read, so the reference replays the same stream.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class LoopSource:
    id = "portbench"

    def __init__(self, wire: np.ndarray | None, fs: float):
        self.fs = float(fs)
        self.block_size = None           # set by the runtime
        self.wire = wire
        self.mode = "idle"
        self.handed: list[tuple[int, float, float]] = []   # (loop idx, due, read at)
        self._cond = threading.Condition()
        self._warm_left = 0
        self._t0 = None
        self._stop_at = None
        self._k = 0
        self.late: list[float] = []

    # -- the runtime's side ----------------------------------------------
    def get_sample_rate(self):
        return self.fs

    def start(self):
        pass

    def _block(self, due: float):
        n = self.block_size
        nblocks = len(self.wire) // n
        idx = len(self.handed) % nblocks
        self.handed.append((idx, due, time.perf_counter()))
        return self.wire[idx * n:(idx + 1) * n]

    def read_block(self, timeout: float = 1.0):
        deadline = time.perf_counter() + timeout
        with self._cond:
            while True:
                now = time.perf_counter()
                wake = deadline
                if self.mode == "warm" and self._warm_left > 0:
                    self._warm_left -= 1
                    return self._block(now)
                if self.mode == "saturate" and now < self._stop_at:
                    return self._block(now)
                if self.mode == "realtime":
                    due = self._t0 + (self._k + 1) * self.block_size / self.fs
                    if due <= self._stop_at:
                        if now >= due:
                            self._k += 1
                            self.late.append(now - due)
                            return self._block(due)
                        wake = min(deadline, due)
                if now >= deadline:
                    return None
                self._cond.wait(max(0.0, wake - now))

    # -- the harness's side ----------------------------------------------
    def warm(self, blocks: int):
        with self._cond:
            self.mode, self._warm_left = "warm", int(blocks)
            self._cond.notify_all()

    def window(self, mode: str, t0: float, seconds: float):
        with self._cond:
            self.mode, self._t0, self._k = mode, t0, 0
            self._stop_at = t0 + seconds
            self._cond.notify_all()

    def idle(self):
        with self._cond:
            self.mode = "idle"
            self._cond.notify_all()
