"""Randomized work stealing: the atomics-minimal baseline.

Motivated by Ahmad et al. ("Low-Depth Parallel Algorithms for the
Binary-Forking Model without Atomics"): the iteration space is
pre-partitioned into blocks dealt block-cyclically into per-thread deques;
a thread pops from its own deque's front and, when empty, steals from a
random victim's back.  No shared counter exists, so ``faa_shared`` and
``faa_total`` are identically zero — the cost moves into (rare) steal
operations, reported in ``ScheduleStats.steals``.
"""

from __future__ import annotations

import collections
import random
import threading
from typing import Callable, Optional

from repro_torch.core.schedulers.base import (Recorder, ScheduleStats, Scheduler,
                                        ThreadPool, register_scheduler,
                                        resolve_block_size)


@register_scheduler
class StealingScheduler(Scheduler):
    """Per-thread block deques with randomized stealing.

    Owner pops are deque-front, steals are deque-back (the classic
    Chase-Lev orientation: thieves take the blocks the owner would reach
    last).  Blocks are never re-enqueued, so a thread that sweeps every
    deque and finds all empty can safely exit — in-flight blocks are
    already claimed exactly once.
    """

    name = "stealing"

    def __init__(self, seed: int = 0):
        self.seed = seed

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
        rec = Recorder(t)

        deques = [collections.deque() for _ in range(t)]
        locks = [threading.Lock() for _ in range(t)]
        for k, begin in enumerate(range(0, n, b)):
            deques[k % t].append((begin, min(n, begin + b)))

        def pop_own(tid: int):
            with locks[tid]:
                return deques[tid].popleft() if deques[tid] else None

        def steal_from(victim: int):
            with locks[victim]:
                return deques[victim].pop() if deques[victim] else None

        def thread_task(tid: int) -> None:
            rng = random.Random(self.seed * 1_000_003 + tid)
            while True:
                blk = pop_own(tid)
                if blk is None:
                    victims = [v for v in range(t) if v != tid]
                    rng.shuffle(victims)
                    for v in victims:
                        blk = steal_from(v)
                        if blk is not None:
                            rec.steals[tid] += 1
                            break
                    if blk is None:
                        return  # every deque empty; nothing can reappear
                begin, end = blk
                for i in range(begin, end):
                    task(i)
                rec.claim(tid, end - begin)

        pool.run(thread_task)
        return rec.stats(self.name, n, b)
