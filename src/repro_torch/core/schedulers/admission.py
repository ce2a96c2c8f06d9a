"""Slot-admission adapter: any registered scheduler drives a request queue.

The serving analogy the paper's thesis maps onto directly: a queue of
requests drained into fixed decode slots *is* a ParallelFor — requests are
the iteration space, slots play the thread role, and each claim on the
pending-request counter is one admission FAA.  ``plan_admission`` runs the
*actual* registered policy (flat ``faa`` = one contended admission counter,
``hierarchical`` = per-group admission lanes, ``stealing`` = per-slot local
queues, plus any custom policy) over ``n`` requests with a pool of
``slots`` threads, and records which slot claimed each request and in what
order.  The policy's own :class:`ScheduleStats` — shared-counter FAAs,
claim-size histogram, imbalance — therefore *is* the admission telemetry;
nothing is re-modelled.

The claimed block size is the admission batch: one FAA admits ``block``
requests to a slot, which then serves them back-to-back without touching
the shared counter again — exactly the paper's B lever, re-read as an
admission policy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Union

import numpy as np

from repro_torch.core.schedulers.base import (ScheduleStats, Scheduler, ThreadPool,
                                        empty_stats, get_scheduler)


class TidRecordingPool(ThreadPool):
    """A :class:`ThreadPool` that remembers which OS thread runs which tid.

    Schedulers invoke ``task(i)`` from inside the claiming thread's loop, so
    a task can discover *which slot claimed it* by looking its own OS thread
    ident up here — the only hook needed to turn any registered policy into
    an admission policy without changing the Scheduler protocol.

    Kept as the standalone (thread-spawning) variant of the hook;
    :func:`plan_admission` itself now runs on the persistent runtime pool,
    whose :class:`repro_torch.core.runtime.ScopedPool` records tids the same way.
    """

    def __init__(self, n_threads: int):
        super().__init__(n_threads)
        self._tid_of: dict = {}

    def run(self, thread_task) -> None:
        def recording(tid: int) -> None:
            self._tid_of[threading.get_ident()] = tid
            thread_task(tid)

        super().run(recording)

    def current_tid(self) -> int:
        return self._tid_of[threading.get_ident()]


@dataclasses.dataclass
class AdmissionPlan:
    """Outcome of one admission pass: who serves what, at what sync cost.

    ``assignment[i]`` is the slot that claimed request ``i``;
    ``claim_order`` lists request ids in global claim order (ties broken by
    wall order of the claiming threads); ``stats`` is the policy's own
    telemetry — ``stats.faa_shared`` is the number of contended
    admission-counter hits the queue paid.
    """

    slots: int
    assignment: np.ndarray        # [n] slot id of each request
    claim_order: list             # request ids in claim order
    stats: ScheduleStats

    def backlog_of(self, slot: int) -> list:
        """Request ids assigned to ``slot``, in that slot's claim order."""
        return [rid for rid in self.claim_order
                if self.assignment[rid] == slot]


def plan_admission(
    n: int,
    slots: int,
    schedule: Union[str, Scheduler],
    *,
    block_size: Optional[int] = None,
    cost_inputs=None,
) -> AdmissionPlan:
    """Assign ``n`` queued requests to ``slots`` decode slots under any
    registered scheduling policy, with honest FAA accounting.

    Runs the real policy (``get_scheduler(schedule).run``) with slots as
    the pool threads; ``task(i)`` records the claiming slot.  Exactly-once
    over the request space is therefore inherited from the policy's own
    contract, and ``block_size`` is the admission batch per shared-counter
    hit (default 1: every admission is a claim, the fully dynamic queue).
    """
    if n < 0:
        raise ValueError("n must be >= 0")
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    sched = get_scheduler(schedule)
    if n == 0:
        return AdmissionPlan(slots, np.zeros(0, np.int64), [],
                             empty_stats(sched.name, slots))
    # the admission pass runs on the shared persistent pool: slots are
    # logical tids on warm workers, not freshly spawned threads
    from repro_torch.core import runtime as _rt

    pool = _rt.get_pool().scoped(slots)
    assignment = np.full(n, -1, np.int64)
    order: list = []
    lock = threading.Lock()

    def claim(i: int) -> None:
        slot = pool.current_tid()
        assignment[i] = slot
        with lock:
            order.append(i)

    stats = sched.run(claim, n, pool,
                      block_size=1 if block_size is None else block_size,
                      cost_inputs=cost_inputs)
    if (assignment < 0).any():
        missing = int((assignment < 0).sum())
        raise RuntimeError(
            f"scheduler {sched.name!r} left {missing} of {n} requests "
            f"unclaimed — exactly-once contract violated")
    _rt.record_stats("admission", stats)
    return AdmissionPlan(slots, assignment, order, stats)
