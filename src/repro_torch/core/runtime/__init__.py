"""Shared execution runtime: one persistent worker pool + one calibrated
tuning context, consulted by every layer.

Port of ``repro.core.runtime``.  Two process-wide singletons live here,
mirroring the paper's two cost levers:

* :func:`get_pool` — the persistent :class:`WorkerPool` that serve
  admission runs its claims on; it aggregates cross-layer
  :class:`ScheduleStats` telemetry.
* :func:`tuning` — the current :class:`TuningContext`: the rational cost
  model's coefficients plus the platform's FAA latencies, calibrated on
  the live host by :func:`calibrate` (persisted at
  ``results/calibration_torch.json``, auto-loaded on first use) or the
  published-weights default when nothing was calibrated.  The
  data-pipeline grain, the ``cost_model`` scheduler, serve admission
  batching, the speculative draft span, autotune's block choices and the
  kernel search's dispatch prior all route their granularity decisions
  through it.

Set ``REPRO_CALIBRATION=off`` to ignore any persisted calibration, or
point it at an alternate JSON path (the variable is the reference's: a
file either package wrote loads in the other).
"""

from __future__ import annotations

import atexit
import os
import threading
from pathlib import Path
from typing import Optional

from repro_torch.core.runtime.calibrate import (HostMeasurement,
                                                TuningContext,
                                                default_context,
                                                load_calibration,
                                                measure_host,
                                                ranking_consistency,
                                                run_calibration,
                                                save_calibration)
from repro_torch.core.runtime.pool import (PoolTelemetry, ScopedPool,
                                           WorkerAbort, WorkerPool)
from repro_torch.core.schedulers.base import ScheduleStats

__all__ = [
    "HostMeasurement",
    "PoolTelemetry",
    "ScopedPool",
    "TuningContext",
    "WorkerAbort",
    "WorkerPool",
    "calibrate",
    "calibration_path",
    "default_context",
    "get_pool",
    "measure_host",
    "ranking_consistency",
    "record_stats",
    "reset_tuning",
    "set_tuning",
    "shutdown",
    "telemetry",
    "tuning",
]

_LOCK = threading.Lock()
_POOL: Optional[WorkerPool] = None
_TUNING: Optional[TuningContext] = None


# ---------------------------------------------------------------------------
# The process-wide pool
# ---------------------------------------------------------------------------

def get_pool() -> WorkerPool:
    """The process-wide persistent pool (created on first use)."""
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = WorkerPool()
            atexit.register(_POOL.shutdown)
        return _POOL


def shutdown() -> None:
    """Tear down the process pool; the next :func:`get_pool` starts fresh."""
    global _POOL
    with _LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown()


def record_stats(layer: str, stats: ScheduleStats) -> None:
    """Aggregate one run's telemetry into the pool's cross-layer window."""
    get_pool().telemetry.record(layer, stats)


def telemetry() -> PoolTelemetry:
    return get_pool().telemetry


# ---------------------------------------------------------------------------
# The process-wide tuning context
# ---------------------------------------------------------------------------

def calibration_path() -> Optional[Path]:
    """Where persisted calibrations live; None when disabled via env."""
    env = os.environ.get("REPRO_CALIBRATION", "")
    if env.lower() in ("off", "0", "none"):
        return None
    if env:
        return Path(env)
    # src/repro_torch/core/runtime/__init__.py -> repo root is parents[4];
    # beside the port's tuning db, apart from the reference's calibration
    return (Path(__file__).resolve().parents[4] / "results"
            / "calibration_torch.json")


def tuning() -> TuningContext:
    """The current :class:`TuningContext`: an installed calibration, else
    a persisted one from :func:`calibration_path`, else the
    published-weights default."""
    global _TUNING
    with _LOCK:
        if _TUNING is None:
            path = calibration_path()
            ctx = load_calibration(path) if path is not None else None
            _TUNING = ctx if ctx is not None else default_context()
        return _TUNING


def set_tuning(ctx: Optional[TuningContext]) -> None:
    """Install (or with None: clear) the process tuning context."""
    global _TUNING
    with _LOCK:
        _TUNING = ctx


def reset_tuning() -> None:
    """Forget the cached context; next :func:`tuning` re-resolves."""
    set_tuning(None)


def calibrate(
    *,
    simulate_only: bool = False,
    fast: bool = False,
    steps: Optional[int] = None,
    restarts: Optional[int] = None,
    persist: bool = True,
    install: bool = True,
    measurement: Optional[HostMeasurement] = None,
    device=None,
) -> TuningContext:
    """Run the online calibration (measure -> sweep -> refit on ``device``,
    the card by default); optionally persist to :func:`calibration_path`
    and install process-wide.  ``measurement`` reuses host
    microbenchmarks the caller already took."""
    ctx = run_calibration(simulate_only=simulate_only, fast=fast,
                          steps=steps, restarts=restarts,
                          measurement=measurement, device=device)
    if persist:
        path = calibration_path()
        if path is not None:
            save_calibration(ctx, path)
    if install:
        set_tuning(ctx)
    return ctx
