"""Discrete-event simulator of ParallelFor under atomic-FAA scheduling.

This container has one CPU core, so the paper's multi-platform wall-clock
sweeps cannot be *measured* here; they are *simulated* with an event model
that encodes exactly the mechanisms the paper identifies:

1. **Serialized FAA line** — the atomic counter lives on one cache line; each
   FAA must acquire ownership, costing ``L(A, S) = R(S) + E(A) + O`` where
   ``R`` depends on who owned the line last (same core < same L3 group <
   cross group/socket).  Ownership transfers are serialized, so under
   contention threads queue on the line.
2. **Scheduling-quota jitter** — a thread's effective speed varies over OS
   scheduling windows; this is the paper's explanation for why the best block
   size sits *below* ``N/T``.
3. **Shared memory bandwidth** — large unit_write/unit_read tasks saturate
   DRAM bandwidth, flattening thread scaling (paper: unit_write 2^16 tables).
4. **Compiler-folded compute** — the paper's unit_task inner `integer += 1`
   loop is constant-folded by any optimizing compiler, which is why measured
   latency is almost flat in unit_comp while the *preferred block size* still
   drifts; we model compute as logarithmic in unit_comp, matching the paper's
   own normalization (C -> log1024).

Latencies are in abstract "clocks" comparable to the paper's tables.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

from repro_torch.core.topology import CpuTopology


@dataclasses.dataclass(frozen=True)
class UnitTask:
    """The paper's configurable unit task (unit_read/unit_write/unit_comp)."""

    unit_read: int = 1024
    unit_write: int = 1024
    unit_comp: int = 1024

    def clocks(self) -> float:
        """Per-iteration cost in clocks for one thread, uncontended.

        read/write scale linearly in bytes (cache-resident streaming),
        compute logarithmically (constant-folded loop; see module docstring).
        """
        c_read, c_write, c_comp = 0.55, 0.75, 45.0
        return (
            c_read * self.unit_read
            + c_write * self.unit_write
            + c_comp * max(1.0, np.log2(max(2.0, float(self.unit_comp))))
        )

    def bytes_touched(self) -> float:
        # writes cost ~2x on the wire (read-for-ownership + writeback)
        return float(self.unit_read + 2 * self.unit_write)


@dataclasses.dataclass
class SimResult:
    e2e_clocks: float
    faa_calls: int
    faa_clocks: float          # total clocks spent inside FAA (incl. queueing)
    per_thread_finish: np.ndarray
    blocks_per_thread: np.ndarray

    @property
    def imbalance(self) -> float:
        f = self.per_thread_finish
        return float((f.max() - f.min()) / max(f.max(), 1.0))


def simulate_parallel_for(
    topo: CpuTopology,
    n_threads: int,
    n: int,
    block_size: int,
    task: UnitTask,
    *,
    schedule: str = "faa",
    seed: int = 0,
    per_claim_extra: float = 0.0,   # library overhead per claim (local)
    per_iter_extra: float = 0.0,    # dispatch overhead per iteration
) -> SimResult:
    """Simulate one ParallelFor(task, n) call.

    Threads are pinned to consecutive cores (the paper's fixed-affinity
    setup).  Returns end-to-end clocks = the time the last thread drains.
    """
    if n_threads > topo.total_cores:
        # oversubscription: multiple threads share a core; model as timeslicing
        # by slowing each thread on that core down proportionally.
        pass
    rng = np.random.RandomState(seed)
    b = max(1, int(block_size))

    cores = np.arange(n_threads) % topo.total_cores
    # per-thread base speed factor (manufacturing/boost variation, small)
    base_speed = 1.0 + 0.02 * rng.randn(n_threads)
    # oversubscription slowdown
    core_load = np.bincount(cores, minlength=topo.total_cores)
    speed = base_speed / core_load[cores]

    # Shared-bandwidth congestion: demanded bytes/clock summed over threads
    # vs the platform's DRAM budget (per memory controller, not per L3).
    bw_budget = topo.bw_bytes_per_clock
    demand_per_thread = task.bytes_touched() / max(task.clocks(), 1.0)
    active = min(n_threads, max(1, n // b))
    congestion = max(1.0, (active * demand_per_thread) / bw_budget)
    iter_clocks = task.clocks() * congestion + per_iter_extra

    def jittered_exec(tid: int, start: float, iters: int) -> float:
        """Execution time of `iters` iterations starting at `start`, applying
        per-quota-window speed jitter (descheduling)."""
        t = start
        remaining = float(iters) * iter_clocks / speed[tid]
        while remaining > 0:
            window_end = (np.floor(t / topo.quota_clocks) + 1) * topo.quota_clocks
            # hash-ish deterministic jitter per (thread, window)
            h = ((tid * 2654435761 + int(t // topo.quota_clocks) * 40503) % 1000) / 1000.0
            factor = 1.0 + topo.quota_jitter * h
            span = window_end - t
            eff = span / factor  # useful clocks available in this window
            if eff >= remaining:
                t += remaining * factor
                remaining = 0.0
            else:
                remaining -= eff
                t = window_end
        return t

    counter = 0
    faa_calls = 0
    faa_clocks = 0.0
    line_free_at = 0.0
    prev_owner = int(cores[0])
    finish = np.zeros(n_threads)
    blocks_done = np.zeros(n_threads, dtype=int)
    done = np.zeros(n_threads, dtype=bool)

    # event queue: (time thread becomes ready, tid)
    ready: list[tuple[float, int]] = [(0.0, tid) for tid in range(n_threads)]
    heapq.heapify(ready)

    q = 0.5 / n_threads  # guided: Taskflow's chunk fraction

    while ready:
        t_ready, tid = heapq.heappop(ready)
        if done[tid]:
            continue
        # claim: serialize on the cache line (+ any local library overhead)
        start = max(t_ready + per_claim_extra, line_free_at)
        cost = topo.faa_cost(prev_owner, int(cores[tid]))
        line_free_at = start + cost
        prev_owner = int(cores[tid])
        faa_calls += 1
        faa_clocks += line_free_at - t_ready
        now = line_free_at
        if counter >= n:
            done[tid] = True
            finish[tid] = max(finish[tid], now)
            continue
        if schedule == "faa":
            size = b
        elif schedule == "guided":
            remaining = n - counter
            size = 1 if remaining < 4 * n_threads else max(1, int(q * remaining))
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        begin = counter
        size = min(size, n - begin)
        counter += size
        end_t = jittered_exec(tid, now, size)
        blocks_done[tid] += 1
        finish[tid] = end_t
        heapq.heappush(ready, (end_t, tid))

    return SimResult(
        e2e_clocks=float(finish.max()),
        faa_calls=faa_calls,
        faa_clocks=faa_clocks,
        per_thread_finish=finish,
        blocks_per_thread=blocks_done,
    )


def sweep_block_sizes(
    topo: CpuTopology,
    n_threads: int,
    task: UnitTask,
    *,
    n: int = 1024,
    block_sizes: Optional[list[int]] = None,
    seeds: int = 3,
) -> dict[int, float]:
    """Mean e2e latency per block size — one paper table column."""
    block_sizes = block_sizes or [2**i for i in range(11)]
    out = {}
    for b in block_sizes:
        runs = [
            simulate_parallel_for(topo, n_threads, n, b, task, seed=s).e2e_clocks
            for s in range(seeds)
        ]
        out[b] = float(np.mean(runs))
    return out


def best_block_size(
    topo: CpuTopology,
    n_threads: int,
    task: UnitTask,
    *,
    n: int = 1024,
    block_sizes: Optional[list[int]] = None,
    seeds: int = 3,
) -> int:
    sweep = sweep_block_sizes(
        topo, n_threads, task, n=n, block_sizes=block_sizes, seeds=seeds
    )
    return min(sweep, key=sweep.get)


# Calibrated against the paper's own Taskflow columns: at unit_read 2^6 the
# paper measures 3.2M clocks vs 257k for the bare cost-model loop — ~2.9k
# clocks/iteration of library overhead, consistent with an executor
# round-trip (task-node allocation + work-stealing deque) per CLAIM, which
# dominates once guided degrades to single-iteration chunks (remaining<4T).
TASKFLOW_CLAIM_OVERHEAD = 4000.0  # executor round-trip per claim
TASKFLOW_ITER_OVERHEAD = 50.0     # functor dispatch per element
TASKFLOW_SETUP_OVERHEAD = 120_000.0  # per-call graph build + submit (~30us)


def simulate_guided(
    topo: CpuTopology, n_threads: int, n: int, task: UnitTask, *, seed: int = 0
) -> SimResult:
    """Taskflow's for_each baseline (paper, Related work).

    Beyond the guided claiming schedule itself, Taskflow pays library
    overheads the paper's bare ParallelFor does not: each claim goes through
    the work-stealing executor (hundreds of clocks), and each element call
    is an std::function dispatch.  The paper's own numbers imply exactly
    this — e.g. W-3225R unit_read 2^6: Taskflow 3.2M clocks vs 257k for the
    bare loop (12x), shrinking to ~16% at unit_read 2^16 where per-element
    work dominates.  A per-call setup term models for_each's task-graph
    construction + executor submission, which a bare pre-pooled ParallelFor
    does not pay."""
    res = simulate_parallel_for(
        topo, n_threads, n, 1, task, schedule="guided", seed=seed,
        per_claim_extra=TASKFLOW_CLAIM_OVERHEAD,
        per_iter_extra=TASKFLOW_ITER_OVERHEAD,
    )
    res.e2e_clocks += TASKFLOW_SETUP_OVERHEAD
    return res
