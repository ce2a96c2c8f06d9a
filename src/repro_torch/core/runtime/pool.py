"""Persistent process-wide worker pool — the paper's amortization argument
applied one level up.

The paper prices ParallelFor by the fixed overhead each *claim* pays (the
atomic FAA, ``L``); this module prices what each *call* pays.  The seed
spawned a fresh ``ThreadPool(n_threads)`` — OS thread creation plus join —
for every ``parallel_for`` call, every data-pipeline batch, every serve
admission pass: an un-amortized per-call ``L`` exactly analogous to the
per-claim FAA.  :class:`WorkerPool` keeps one process-wide set of worker
threads alive and hands out :class:`ScopedPool` views, so steady-state
calls reuse warm threads and create none.

Sizing is lazy and demand-driven: a worker is spawned only when a job is
submitted and no worker is idle, so the pool grows to the high-water
concurrency of the process and then stays there (the test
``tests/test_runtime.py::test_steady_state_creates_no_new_threads`` pins
this down with ``threading.active_count()``).  Jobs never queue behind a
busy worker, which also makes nested ``parallel_for`` calls (a task that
itself runs a ParallelFor) deadlock-free by construction.

:class:`ScopedPool` satisfies the schedulers' ``ThreadPool`` contract —
``run(thread_task)`` executes ``thread_task(tid)`` for tids ``0..n-1``
with the caller participating as tid 0, and after every thread drains
re-raises the captured task errors (one error as itself, several as a
``PoolErrorGroup`` naming every failed tid) — and additionally records
which OS thread ran which tid (``current_tid``), which is the only hook
the admission adapter needs.

Because the pool outlives any single call, its :class:`PoolTelemetry` can
aggregate the :class:`ScheduleStats` of every run *across layers* (data
pipeline, serve admission, bare parallel_for) instead of the numbers
vanishing with each throwaway pool.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

from repro_torch.core.schedulers.base import (ScheduleStats, ThreadPool,
                                        raise_task_errors)

__all__ = ["PoolTelemetry", "ScopedPool", "WorkerAbort", "WorkerPool"]

_STOP = object()


class WorkerAbort(BaseException):
    """Raise inside a pool job to kill the worker thread running it.

    The fault injector's worker-crash vector (and the test hook for any
    externally-died thread): the pool treats it as the thread's death —
    the worker leaves the roster instead of re-marking itself idle, so the
    accounting stays consistent and the next submit spawns a replacement
    rather than handing work to a ghost.  Derives from BaseException so
    blanket ``except Exception`` task wrappers cannot accidentally revive
    a crashed worker."""


class PoolTelemetry:
    """Cross-layer aggregation of every ScheduleStats run on the pool.

    One row per layer tag (``parallel_for``, ``data``, ``serve``,
    ``admission``, …): run count, items executed, FAA totals and the
    shared-counter subset, steals.  ``snapshot`` returns plain dicts for
    logging/benchmark CSVs; ``reset`` starts a fresh window.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._layers: Dict[str, Dict[str, int]] = {}

    def record(self, layer: str, stats: ScheduleStats) -> None:
        with self._lock:
            row = self._layers.setdefault(
                layer, {"runs": 0, "items": 0, "faa_total": 0,
                        "faa_shared": 0, "steals": 0})
            row["runs"] += 1
            row["items"] += stats.n
            row["faa_total"] += stats.faa_total
            row["faa_shared"] += stats.faa_shared
            row["steals"] += stats.steals

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {layer: dict(row) for layer, row in self._layers.items()}

    def totals(self) -> Dict[str, int]:
        out = {"runs": 0, "items": 0, "faa_total": 0, "faa_shared": 0,
               "steals": 0}
        for row in self.snapshot().values():
            for k in out:
                out[k] += row[k]
        return out

    def reset(self) -> None:
        with self._lock:
            self._layers.clear()


class WorkerPool:
    """Lazily-sized, persistent, shareable thread pool.

    ``submit`` hands a zero-argument job to an idle persistent worker,
    spawning a new one only when none is idle — so worker count converges
    to the process's high-water concurrency and steady-state submissions
    reuse warm threads.  ``scoped(n)`` adapts the pool to the schedulers'
    ``ThreadPool`` protocol without giving up sharing.
    """

    def __init__(self, name: str = "repro-runtime"):
        self.name = name
        self._tasks: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._workers: list[threading.Thread] = []
        self._closed = False
        self.telemetry = PoolTelemetry()

    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def submit(self, fn: Callable[[], None],
               on_done: Optional[Callable[[], None]] = None) -> None:
        """Run ``fn()`` on a persistent worker (never the calling thread).

        The job must do its own error handling: a job that raises is
        swallowed by the worker loop (the worker survives), so wrappers
        like :meth:`ScopedPool.run` capture exceptions into caller-visible
        slots before submitting.

        ``on_done`` fires after the worker has re-marked itself idle —
        waiters signalled through it can submit again immediately without
        racing the idle accounting into a redundant thread spawn.  It must
        not raise.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError(f"WorkerPool {self.name!r} is shut down")
            if self._idle > 0:
                self._idle -= 1
            else:
                w = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name=f"{self.name}-{len(self._workers)}")
                self._workers.append(w)
                w.start()
            # enqueue under the lock: a concurrent shutdown() must not slot
            # its _STOP sentinels ahead of this job (the job would never
            # run and its waiter would block forever)
            self._tasks.put((fn, on_done))

    def _worker_loop(self) -> None:
        while True:
            item = self._tasks.get()
            if item is _STOP:
                return
            fn, on_done = item
            crashed = False
            try:
                fn()
            except WorkerAbort:
                # forced/injected worker death: leave the roster instead of
                # re-marking idle — a dead thread counted idle would absorb
                # a later submit's idle-slot claim and wedge the pool (the
                # job sits in the queue with one fewer reader than the
                # accounting promises)
                crashed = True
            except BaseException:  # noqa: BLE001 — see submit()
                pass
            with self._lock:
                if crashed:
                    try:
                        self._workers.remove(threading.current_thread())
                    except ValueError:
                        pass
                else:
                    self._idle += 1
            if on_done is not None:
                try:
                    on_done()
                except BaseException:  # noqa: BLE001 — a raising on_done
                    pass  # must not kill the worker or skew idle counts
            if crashed:
                return

    def scoped(self, n_threads: int) -> "ScopedPool":
        """A ``ThreadPool``-contract view running on the shared workers."""
        return ScopedPool(self, n_threads)

    def shutdown(self) -> None:
        """Stop and join every worker; subsequent submits raise."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers)
        for _ in workers:
            self._tasks.put(_STOP)
        for w in workers:
            w.join(timeout=5.0)


class ScopedPool(ThreadPool):
    """A view of a shared :class:`WorkerPool` with the schedulers'
    ``ThreadPool`` shape: ``n_threads`` logical threads, the caller
    participating as tid 0, per-tid error capture re-raised after the
    pool drains (one failure as itself, several as a ``PoolErrorGroup``).

    Also serves as the admission adapter's tid-recording pool: during
    ``run`` each logical thread registers its OS thread ident, so a task
    can discover which tid (slot) claimed it via :meth:`current_tid`.
    """

    def __init__(self, pool: WorkerPool, n_threads: int):
        super().__init__(n_threads)
        self.pool = pool
        self._tid_of: dict = {}

    def run(self, thread_task: Callable[[int], None]) -> None:
        n = self.n_threads
        errors: list = [None] * n
        pending = n - 1
        cond = threading.Condition()

        def job(tid: int) -> None:
            self._tid_of[threading.get_ident()] = tid
            try:
                thread_task(tid)
            except WorkerAbort as e:
                # a forced worker death is still this tid's failure, but it
                # must ALSO reach the worker loop so the thread actually
                # dies (accounting restored there).  Never re-raise on the
                # caller's own thread — tid 0 has no worker to kill.
                errors[tid] = e
                if tid != 0:
                    raise
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[tid] = e

        def done() -> None:
            # runs in the worker AFTER it re-marked itself idle (or left
            # the roster, if it crashed), so a caller unblocked here can
            # submit again without spawning a redundant thread
            nonlocal pending
            with cond:
                pending -= 1
                cond.notify_all()

        for tid in range(1, n):
            self.pool.submit(lambda tid=tid: job(tid), on_done=done)
        job(0)
        with cond:
            while pending:
                cond.wait()
        raise_task_errors(errors)

    def current_tid(self) -> int:
        return self._tid_of[threading.get_ident()]
