"""openmp-static: pre-partition [0, N) into T contiguous ranges, zero FAA."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.schedulers.base import (Recorder, ScheduleStats, Scheduler,
                                        ThreadPool, register_scheduler)


@register_scheduler
class StaticScheduler(Scheduler):
    """Contiguous equal split decided before any thread starts.

    The zero-synchronization baseline: no claim counter exists, so the FAA
    count is identically zero — but so is any ability to rebalance, which
    is why the paper's quota-jitter makes it lose to dynamic claiming on
    irregular work.
    """

    name = "static"

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
        rec = Recorder(t)
        bounds = np.linspace(0, n, t + 1).astype(int)

        def thread_task(tid: int) -> None:
            begin, end = int(bounds[tid]), int(bounds[tid + 1])
            for i in range(begin, end):
                task(i)
            if end > begin:
                rec.claim(tid, end - begin)

        pool.run(thread_task)
        return rec.stats(self.name, n, block_size)

    def device_block_size(self, n, workers, block_size=None,
                          cost_inputs=None):
        # one contiguous range per worker; an explicit B is meaningless here
        return max(1, -(-n // workers))
