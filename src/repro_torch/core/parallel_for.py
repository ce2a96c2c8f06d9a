"""ParallelFor — the paper's subject, implemented faithfully.

The reference semantics (paper, "Problem statement"): a thread pool in which
every thread claims ``block_size`` iterations at a time from a shared atomic
counter via fetch-and-add, runs ``task(i)`` for each claimed ``i``, and loops
until the counter passes ``N``. ``ParallelFor`` returns once all threads have
drained — the caller is assured ``task`` ran exactly once for every
``i in [0, N)``.

Scheduling policies live in :mod:`repro_torch.core.schedulers` — a
registry, not a branch (``static``, ``faa``, ``guided``, ``cost_model``,
``hierarchical``, ``stealing``; all exactly-once, all tested).
:func:`parallel_for_stats` returns the full
:class:`~repro_torch.core.schedulers.ScheduleStats` telemetry (FAA calls
total / shared / per-thread, claim-size histogram, imbalance);
:func:`parallel_for` is the seed-compatible wrapper returning the bare FAA
count.

Port of the host half of ``repro.core.parallel_for``.  The on-device
ParallelFor (``device_parallel_for``) is not ported yet (ROADMAP:
distributed and launch); :func:`block_cyclic_assignment` is its claim
layout and is ported already.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np

from repro_torch.core import cost_model as _cm
from repro_torch.core import faults as _faults
from repro_torch.core import runtime as _rt
from repro_torch.core import schedulers as _sched
from repro_torch.core.schedulers import (AtomicCounter, ScheduleStats,
                                         Scheduler, ThreadPool)

__all__ = [
    "AtomicCounter",
    "ThreadPool",
    "parallel_for",
    "parallel_for_stats",
    "block_cyclic_assignment",
    "grain_sizes",
]


def parallel_for_stats(
    task: Callable[[int], None],
    n: int,
    *,
    pool: Optional[ThreadPool] = None,
    n_threads: int = 4,
    schedule: Union[str, Scheduler] = "faa",
    block_size: Optional[int] = None,
    cost_inputs: Optional[_cm.WorkloadFeatures] = None,
    layer: str = "parallel_for",
) -> ScheduleStats:
    """Run ``task(i)`` for every i in [0, n) under the named scheduling
    policy; returns the run's full :class:`ScheduleStats` telemetry.

    ``schedule`` is a registered policy name or a pre-configured
    :class:`Scheduler` instance (e.g. ``HierarchicalScheduler(groups=8)``).

    With no explicit ``pool`` the call runs on the process-wide persistent
    :class:`repro_torch.core.runtime.WorkerPool` — steady-state calls spawn
    no threads.  ``layer`` tags the run in the pool's cross-layer telemetry
    (``repro_torch.core.runtime.telemetry()``).
    """
    if n < 0:
        raise ValueError("n must be >= 0")
    sched = _sched.get_scheduler(schedule)
    pool = pool or _rt.get_pool().scoped(n_threads)
    # fault injection resolves at the call boundary: one global read when
    # no plan is installed (the zero-overhead contract), a task wrapper at
    # the claim boundary when this run's layer is targeted
    inj = _faults.active()
    run_faults = inj.for_layer(layer) if inj is not None else None
    if run_faults is not None:
        task = run_faults.wrap(task)
    if n == 0:
        stats = _sched.empty_stats(sched.name, pool.n_threads)
    else:
        stats = sched.run(task, n, pool, block_size=block_size,
                          cost_inputs=cost_inputs)
    if run_faults is not None:
        stats.injected_stall_s += run_faults.stall_s
        stats.injected_faults += run_faults.fired
    _rt.record_stats(layer, stats)
    return stats


def parallel_for(
    task: Callable[[int], None],
    n: int,
    *,
    pool: Optional[ThreadPool] = None,
    n_threads: int = 4,
    schedule: Union[str, Scheduler] = "faa",
    block_size: Optional[int] = None,
    cost_inputs: Optional[_cm.WorkloadFeatures] = None,
    layer: str = "parallel_for",
) -> int:
    """Seed-compatible wrapper: run and return the number of atomic FAA
    calls issued (the paper's cost driver).  Use
    :func:`parallel_for_stats` for the structured telemetry."""
    return parallel_for_stats(
        task, n, pool=pool, n_threads=n_threads, schedule=schedule,
        block_size=block_size, cost_inputs=cost_inputs, layer=layer,
    ).faa_total


def block_cyclic_assignment(n: int, block_size: int,
                            workers: int) -> np.ndarray:
    """Deterministic replacement for FAA claiming: block k goes to worker
    ``k % workers``. Returns an int array [n] with the owning worker of each
    iteration — the claim order FAA would produce under perfect balance."""
    blocks = -(-n // block_size)
    owner_of_block = np.arange(blocks) % workers
    return np.repeat(owner_of_block, block_size)[:n]


def grain_sizes(n: int, block_size: int) -> List[tuple[int, int]]:
    """[(begin, end)] blocks of the iteration space — shared helper."""
    return [(i, min(n, i + block_size)) for i in range(0, n, block_size)]
