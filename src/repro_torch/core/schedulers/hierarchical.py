"""Hierarchical FAA: per-core-group counters over shared super-blocks.

Directly models the paper's cross-group observation (and Schweizer et
al.'s measurements): a FAA whose cache line last lived in another core
group pays the slow interconnect (mesh / UPI / infinity-fabric), while a
FAA on a line owned within the group is several times cheaper.  So: keep
the per-claim counter *inside* each group, and touch the single shared
counter only when a group drains its range — once per ``fanout`` claims
instead of once per claim.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.core.schedulers.base import (AtomicCounter, Recorder,
                                        ScheduleStats, Scheduler, ThreadPool,
                                        register_scheduler,
                                        resolve_block_size)


@register_scheduler
class HierarchicalScheduler(Scheduler):
    """Two-level claiming: group-local counters refilled from a shared one.

    Threads are split contiguously into ``groups`` core groups (default:
    ``cost_inputs.core_groups`` when given, else one group per 4 threads —
    the AMD-CCX shape).  A thread claims ``B`` iterations from its group's
    local counter (a group-local FAA, cheap); when the local range drains,
    the claiming thread refills it with a super-block of ``fanout * B``
    iterations from the shared counter (a shared FAA, expensive).

    Versus flat ``faa`` at equal B the shared-counter traffic drops from
    ``ceil(N/B) + T`` to ``ceil(N/(fanout*B)) + T`` — claims stay B-sized,
    but the contended line is touched ``fanout`` times less.  The price is
    a coarser *shared* granularity: the final super-block drains inside one
    group with no cross-group rebalancing, so the tail imbalance can reach
    ``fanout * B`` items instead of B (exactly the ``quota·B·fanout`` term
    ``analytic_hierarchical_cost`` charges).  ``ScheduleStats.faa_shared``
    vs ``faa_total`` makes the FAA split observable; ``imbalance`` the
    tail.
    """

    name = "hierarchical"

    def __init__(self, groups: Optional[int] = None, fanout: int = 8):
        if fanout < 2:
            raise ValueError("fanout must be >= 2 (1 would be flat faa)")
        self.groups = groups
        self.fanout = fanout

    def run(
        self,
        task: Callable[[int], None],
        n: int,
        pool: ThreadPool,
        *,
        block_size: Optional[int] = None,
        cost_inputs=None,
    ) -> ScheduleStats:
        t = pool.n_threads
        b = resolve_block_size(n, t, block_size)
        g = self.groups
        if g is None:
            g = getattr(cost_inputs, "core_groups", None) or max(1, t // 4)
        g = max(1, min(int(g), t))
        superblock = b * self.fanout

        rec = Recorder(t)
        shared = AtomicCounter()
        # group-local claim state; the lock serializes claims within a group
        # exactly as a group-local atomic counter would.
        group_state = [
            {"next": 0, "end": 0, "lock": threading.Lock()} for _ in range(g)
        ]
        group_of = [tid * g // t for tid in range(t)]

        def thread_task(tid: int) -> None:
            gs = group_state[group_of[tid]]
            while True:
                with gs["lock"]:
                    if gs["next"] >= gs["end"]:
                        # local range drained -> refill from the shared
                        # counter (the only cross-group FAA in the policy)
                        sb = shared.fetch_and_add(superblock)
                        rec.faa[tid] += 1
                        rec.faa_shared[tid] += 1
                        if sb >= n:
                            return
                        gs["next"], gs["end"] = sb, min(n, sb + superblock)
                    begin = gs["next"]
                    size = min(b, gs["end"] - begin)
                    gs["next"] = begin + size
                    rec.faa[tid] += 1   # group-local FAA
                for i in range(begin, begin + size):
                    task(i)
                rec.claim(tid, size)

        pool.run(thread_task)
        return rec.stats(self.name, n, b)

    def device_block_size(self, n, workers, block_size=None,
                          cost_inputs=None):
        # super-blocks stay with one worker, capped at a contiguous share
        b = resolve_block_size(n, workers, block_size)
        return min(max(1, -(-n // workers)), b * self.fanout)
