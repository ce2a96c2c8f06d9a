"""Taskflow's guided self-scheduling: exponentially shrinking claims."""

from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.core.schedulers.base import (AtomicCounter, Recorder,
                                        ScheduleStats, Scheduler, ThreadPool,
                                        register_scheduler)


@register_scheduler
class GuidedScheduler(Scheduler):
    """Each claim takes ``q * remaining`` iterations with ``q = 0.5 / T``,
    degrading to single-iteration claims once ``remaining < 4T``
    (paper, "Related work and comparison").

    Early claims are huge (cheap amortized FAA), late claims tiny (good
    balance) — but the single-iteration tail is exactly where Taskflow's
    per-claim executor overhead explodes, which is the gap the paper's
    cost-model blocks exploit.
    """

    name = "guided"

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
        q = 0.5 / t
        counter = AtomicCounter()
        lock = threading.Lock()

        def claim(tid: int) -> tuple:
            with lock:
                begin = counter.value
                if begin >= n:
                    return n, n
                remaining = n - begin
                if remaining < 4 * t:
                    size = 1
                else:
                    size = max(1, int(q * remaining))
                counter.fetch_and_add(size)
                rec.faa[tid] += 1
                rec.faa_shared[tid] += 1
                return begin, min(n, begin + size)

        def thread_task(tid: int) -> None:
            while True:
                begin, end = claim(tid)
                if begin >= n:
                    return
                for i in range(begin, end):
                    task(i)
                rec.claim(tid, end - begin)

        pool.run(thread_task)
        return rec.stats(self.name, n, block_size)

    def device_block_size(self, n, workers, block_size=None,
                          cost_inputs=None):
        # no shrinking claims in a static layout; use the mean guided chunk
        return block_size or max(1, n // (4 * workers))
