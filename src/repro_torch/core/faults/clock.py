"""ChaosClock: the deterministic time source behind injected stalls.

An injected straggler has two jobs — *account* for the stall (so the
exposed-wait telemetry the cost model is validated against is exact) and
optionally *be* the stall (so wall-clock percentiles actually inflate).
Virtual mode (the default) does only the first: ``sleep`` adds to the
elapsed ledger and returns immediately, which keeps seeded chaos tests
fast and bit-reproducible.  Real mode additionally burns the wall clock,
which is what the chaos benchmark uses to show injected stalls moving
p95 exactly as the calibrated cost model's contention term predicts.
"""

from __future__ import annotations

import threading
import time

__all__ = ["ChaosClock"]


class ChaosClock:
    """Accounting (and optionally wall-clock) sleep for injected stalls."""

    def __init__(self, real: bool = False):
        self.real = real
        self._elapsed = 0.0
        self._lock = threading.Lock()

    @property
    def elapsed_s(self) -> float:
        """Total stall seconds charged through this clock."""
        with self._lock:
            return self._elapsed

    def sleep(self, duration_s: float) -> float:
        """Charge ``duration_s`` of stall; really sleep only in real mode.
        Returns the charged duration (convenience for accumulators)."""
        if duration_s < 0:
            raise ValueError(f"stall duration must be >= 0, got {duration_s}")
        with self._lock:
            self._elapsed += duration_s
        if self.real and duration_s > 0:
            time.sleep(duration_s)
        return duration_s
