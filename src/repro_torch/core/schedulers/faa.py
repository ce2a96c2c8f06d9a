"""The paper's dynamic FAA scheduler: fixed-size blocks claimed from one
shared atomic counter."""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.schedulers.base import (AtomicCounter, Recorder,
                                        ScheduleStats, Scheduler, ThreadPool,
                                        register_scheduler,
                                        resolve_block_size)


@register_scheduler
class FaaScheduler(Scheduler):
    """Every thread loops ``begin = counter.fetch_and_add(B)`` until the
    counter passes N (paper, "Problem statement").

    Each claim — including the final drain probe every thread issues before
    exiting — is one FAA on the shared cache line, so
    ``faa_shared = ceil(N/B) + T`` and the block size B is the only lever
    on synchronization cost.  The default B = N/(8T) gives each thread ~8
    claims: enough rebalancing headroom against quota jitter without
    FAA-storming the line.
    """

    name = "faa"

    def _block_size(self, n: int, t: int, block_size: Optional[int],
                    cost_inputs) -> int:
        return resolve_block_size(n, t, block_size)

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
        b = max(1, min(int(self._block_size(n, t, block_size, cost_inputs)), n))
        rec = Recorder(t)
        counter = AtomicCounter()

        def thread_task(tid: int) -> None:
            while True:
                begin = counter.fetch_and_add(b)
                rec.faa[tid] += 1
                rec.faa_shared[tid] += 1
                if begin >= n:
                    return
                end = min(n, begin + b)
                for i in range(begin, end):
                    task(i)
                rec.claim(tid, end - begin)

        pool.run(thread_task)
        return rec.stats(self.name, n, b)

    def device_block_size(self, n, workers, block_size=None,
                          cost_inputs=None):
        # block-cyclic at the requested B (default: one block per worker,
        # the seed's device layout)
        return block_size or max(1, n // workers)
