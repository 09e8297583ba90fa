"""Fault-tolerance utilities, as ``repro.train.fault``: the preemption
guard (SIGTERM sets a flag that a loop polls at its boundaries, never
mid-step) and a straggler-aware step timer.  The guard is the port's only
one: the engine's checkpointer (``engine/recovery.py``) imports it too."""
from __future__ import annotations

import signal
import time
from collections import deque
from typing import Optional


class PreemptionGuard:
    """Installs signal handlers that set a flag the caller polls at its
    boundaries.  ``chain=True`` keeps any previously installed Python
    handler live: the guard sets its flag and then forwards the signal."""

    def __init__(self, signals=(signal.SIGTERM,), chain: bool = False):
        self.requested = False
        self.chain = chain
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass   # not the main thread

    def _handler(self, signum, frame):
        self.requested = True
        if self.chain:
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepTimer:
    """Tracks step latencies; counts a step slower than ``threshold`` times
    the median of the last ``window`` (once 10 are in) as a straggler."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self._t0: Optional[float] = None
        self.stragglers = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.stragglers += 1
        self.times.append(dt)

    @property
    def median(self):
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]
