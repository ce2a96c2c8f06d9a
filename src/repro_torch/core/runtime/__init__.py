"""Shared execution runtime: one persistent worker pool + the tuning
context, consulted by every layer.

* :func:`get_pool` — the persistent :class:`WorkerPool` that serve
  admission runs its claims on; it aggregates cross-layer
  :class:`ScheduleStats` telemetry.
* :func:`tuning` — the :class:`TuningContext`: the paper's published
  weights and the reference platform's FAA latencies (the reference's
  default when no calibration is installed).
"""

from __future__ import annotations

import atexit
import threading
from typing import Optional

from repro_torch.core.runtime.calibrate import TuningContext, default_context
from repro_torch.core.runtime.pool import (PoolTelemetry, ScopedPool,
                                           WorkerAbort, WorkerPool)
from repro_torch.core.schedulers.base import ScheduleStats

__all__ = [
    "PoolTelemetry",
    "ScopedPool",
    "TuningContext",
    "WorkerAbort",
    "WorkerPool",
    "default_context",
    "get_pool",
    "record_stats",
    "telemetry",
    "tuning",
]

_LOCK = threading.Lock()
_POOL: Optional[WorkerPool] = None
_TUNING: Optional[TuningContext] = None


def get_pool() -> WorkerPool:
    """The process-wide persistent pool (created on first use)."""
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = WorkerPool()
            atexit.register(_POOL.shutdown)
        return _POOL


def record_stats(layer: str, stats: ScheduleStats) -> None:
    """Aggregate one run's telemetry into the pool's cross-layer window."""
    get_pool().telemetry.record(layer, stats)


def telemetry() -> PoolTelemetry:
    return get_pool().telemetry


def tuning() -> TuningContext:
    """The process :class:`TuningContext` (the published-weights default)."""
    global _TUNING
    with _LOCK:
        if _TUNING is None:
            _TUNING = default_context()
        return _TUNING
