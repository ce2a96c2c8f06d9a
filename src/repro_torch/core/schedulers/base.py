"""Scheduler protocol, registry, and the telemetry they all report.

The paper's central observation is that ParallelFor latency tracks the
number of fetch-and-add calls on the shared claim counter.  Every scheduler
in this package therefore reports a :class:`ScheduleStats` — FAA calls in
total and per thread, split into *shared-counter* FAAs (the expensive,
contended line the paper measures) and group-local ones (cheap, stay inside
one L3 domain), plus the claim-size histogram and the per-thread item
imbalance.  A bare FAA count is what the seed's ``parallel_for`` returned;
``ScheduleStats`` is its structured replacement.

Registering a scheduler::

    @register_scheduler
    class MyScheduler(Scheduler):
        name = "mine"
        def run(self, task, n, pool, *, block_size=None, cost_inputs=None):
            ...

    parallel_for(task, n, schedule="mine")

Any object with a ``name`` attribute and a matching ``run`` method
satisfies the protocol — subclassing :class:`Scheduler` is convenient, not
required.
"""

from __future__ import annotations

import abc
import collections
import dataclasses
import threading
from typing import Callable, ClassVar, Dict, Optional, Type, Union

import numpy as np


class AtomicCounter:
    """fetch_and_add with the memory semantics the paper relies on."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def fetch_and_add(self, delta: int) -> int:
        with self._lock:
            old = self._value
            self._value += delta
            return old

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class PoolErrorGroup(RuntimeError):
    """More than one pool task failed in a single run.

    The message names every failed tid with its exception, so a
    multi-worker fault is diagnosable from the traceback alone instead of
    showing only the lowest tid's error (the others used to be silently
    dropped).  ``errors`` holds the per-tid exceptions in tid order."""

    def __init__(self, errors: list):
        self.errors = list(errors)
        detail = "; ".join(
            f"tid {tid}: {type(e).__name__}: {e}" for tid, e in self.errors)
        super().__init__(
            f"{len(self.errors)} pool task(s) failed: {detail}")


def raise_task_errors(errors: list) -> None:
    """Surface per-tid captured exceptions to the pool's caller.

    Exactly one error re-raises as itself (type-compatible with every
    pre-group caller: ``except ValueError`` keeps working); two or more
    aggregate into a :class:`PoolErrorGroup` naming every failed tid."""
    failed = [(tid, e) for tid, e in enumerate(errors) if e is not None]
    if not failed:
        return
    if len(failed) == 1:
        raise failed[0][1]
    raise PoolErrorGroup(failed)


class ThreadPool:
    """A minimal pool with the enqueue/wait shape of the paper's snippet."""

    def __init__(self, n_threads: int):
        if n_threads < 1:
            raise ValueError("need at least one thread")
        self.n_threads = n_threads

    def run(self, thread_task: Callable[[int], None]) -> None:
        """Run ``thread_task(thread_id)`` on all threads; the calling thread
        participates as thread 0 (as in the paper: ``thread_task()`` is also
        invoked inline after enqueueing).

        A ``task`` that raises must surface to the caller, not die silently
        inside a worker thread: every thread's first exception is captured,
        the surviving threads drain normally (no policy blocks waiting on a
        peer, so join() cannot deadlock), and the captured errors re-raise
        here — one error as itself, several as a :class:`PoolErrorGroup`.
        """
        errors: list = [None] * self.n_threads

        def guarded(tid: int) -> None:
            try:
                thread_task(tid)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[tid] = e

        workers = [
            threading.Thread(target=guarded, args=(tid,))
            for tid in range(1, self.n_threads)
        ]
        for w in workers:
            w.start()
        guarded(0)
        for w in workers:
            w.join()
        raise_task_errors(errors)


@dataclasses.dataclass
class ScheduleStats:
    """Telemetry of one ParallelFor run — the paper's cost terms, observable.

    ``faa_per_thread`` counts *every* atomic fetch-and-add a thread issued on
    any counter; ``faa_shared`` counts only those that hit the single global
    counter (the contended cache line whose ownership transfers the paper
    prices at ``L(A,S) = R(S) + E(A) + O``).  For flat schedulers the two
    coincide; ``hierarchical`` exists precisely to drive ``faa_shared`` down
    while keeping claims fine-grained, and ``stealing`` issues no FAA at all.
    """

    schedule: str
    n: int
    n_threads: int
    block_size: Optional[int]
    faa_per_thread: np.ndarray      # all atomic FAAs issued, by thread
    faa_shared_per_thread: np.ndarray  # FAAs on the single shared counter
    items_per_thread: np.ndarray    # iterations executed, by thread
    claim_sizes: Dict[int, int]     # histogram: claimed-block size -> count
    steals: int = 0                 # successful steals (stealing policy only)
    # ---- fault-injection telemetry (zeros outside a fault_scope) ----
    injected_stall_s: float = 0.0   # exposed wait charged by injected stalls
    injected_faults: int = 0        # injected task faults / crashes raised

    @property
    def faa_total(self) -> int:
        return int(self.faa_per_thread.sum())

    @property
    def faa_shared(self) -> int:
        return int(self.faa_shared_per_thread.sum())

    @property
    def blocks_claimed(self) -> int:
        return sum(self.claim_sizes.values())

    @property
    def imbalance(self) -> int:
        """max − min items executed per thread (the paper's quota-jitter
        tail shows up here: one oversized final block strands a thread)."""
        if self.items_per_thread.size == 0:
            return 0
        return int(self.items_per_thread.max() - self.items_per_thread.min())

    def as_row(self) -> dict:
        """Flat dict for benchmark CSVs."""
        return {
            "schedule": self.schedule,
            "n": self.n,
            "threads": self.n_threads,
            "block_size": self.block_size if self.block_size is not None else "",
            "faa_total": self.faa_total,
            "faa_shared": self.faa_shared,
            "blocks": self.blocks_claimed,
            "steals": self.steals,
            "imbalance": self.imbalance,
        }


class Recorder:
    """Per-thread stat accumulators (each thread writes only its own slot,
    so no locking beyond what the scheduler itself does)."""

    def __init__(self, n_threads: int):
        self.faa = np.zeros(n_threads, np.int64)
        self.faa_shared = np.zeros(n_threads, np.int64)
        self.items = np.zeros(n_threads, np.int64)
        self.steals = np.zeros(n_threads, np.int64)
        self._claims = [collections.Counter() for _ in range(n_threads)]

    def claim(self, tid: int, size: int) -> None:
        self.items[tid] += size
        self._claims[tid][size] += 1

    def stats(self, schedule: str, n: int,
              block_size: Optional[int]) -> ScheduleStats:
        merged: collections.Counter = collections.Counter()
        for c in self._claims:
            merged.update(c)
        return ScheduleStats(
            schedule=schedule,
            n=n,
            n_threads=len(self.items),
            block_size=block_size,
            faa_per_thread=self.faa,
            faa_shared_per_thread=self.faa_shared,
            items_per_thread=self.items,
            claim_sizes=dict(merged),
            steals=int(self.steals.sum()),
        )


def empty_stats(schedule: str, n_threads: int) -> ScheduleStats:
    """Stats of a zero-length loop (no thread ever launched)."""
    return Recorder(n_threads).stats(schedule, 0, None)


def resolve_block_size(n: int, n_threads: int, block_size: Optional[int],
                       *, per_thread_claims: int = 8) -> int:
    """The block-claiming policies' shared default and clamp: an explicit
    B wins; otherwise give each thread ~``per_thread_claims`` claims
    (rebalancing headroom against quota jitter without FAA-storming the
    line).  Always clamped to [1, n]."""
    b = (block_size if block_size is not None
         else n // (per_thread_claims * n_threads))
    return max(1, min(int(b), n))


class Scheduler(abc.ABC):
    """A ParallelFor claiming policy.

    ``run`` must invoke ``task(i)`` exactly once for every ``i in [0, n)``
    (``n >= 1``; the ``n == 0`` case never reaches a scheduler) and return
    the run's :class:`ScheduleStats`.  ``cost_inputs`` is the workload
    description the cost model consumes (``repro_torch.core.cost_model
    .WorkloadFeatures``); policies that don't consult it must still accept
    it.
    """

    name: ClassVar[str] = ""

    @abc.abstractmethod
    def run(
        self,
        task: Callable[[int], None],
        n: int,
        pool: ThreadPool,
        *,
        block_size: Optional[int] = None,
        cost_inputs=None,
    ) -> ScheduleStats:
        ...

    def device_block_size(
        self,
        n: int,
        workers: int,
        block_size: Optional[int] = None,
        cost_inputs=None,
    ) -> int:
        """Block size of this policy's shard layout on device.

        On device the claim is deterministic block-cyclic, so a policy *is*
        its layout; this hook keeps the device path registry-driven (custom
        policies inherit a sensible fine-grained layout).  Built-ins
        override it — see each policy.
        """
        return resolve_block_size(n, workers, block_size)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Scheduler]] = {}


def register_scheduler(
    cls: Optional[Type[Scheduler]] = None,
    *,
    name: Optional[str] = None,
    override: bool = False,
):
    """Register a scheduler class under ``name`` (default: ``cls.name``).

    Usable bare (``@register_scheduler``) or with arguments
    (``@register_scheduler(name="x", override=True)``).  Re-registering an
    existing name without ``override=True`` raises — silent replacement of
    a policy someone is benchmarking against is how results go wrong.
    """

    def _register(c: Type[Scheduler]) -> Type[Scheduler]:
        key = name or getattr(c, "name", "")
        if not key:
            raise ValueError(
                f"{c.__name__} has no `name` attribute and no name= was given")
        if key in _REGISTRY and not override:
            raise ValueError(
                f"scheduler {key!r} is already registered "
                f"(pass override=True to replace it)")
        _REGISTRY[key] = c
        return c

    if cls is not None:
        return _register(cls)
    return _register


def get_scheduler(name: Union[str, Scheduler]) -> Scheduler:
    """Resolve a policy name to a fresh scheduler instance.

    A :class:`Scheduler` instance — or any object with ``name`` and ``run``
    (the duck-typed protocol) — passes through unchanged, so callers can
    hand a pre-configured policy (e.g. ``HierarchicalScheduler(groups=8)``)
    anywhere a name is accepted.
    """
    if not isinstance(name, str) and hasattr(name, "run"):
        return name
    try:
        cls = _REGISTRY[name]
    except KeyError:
        # ValueError, matching the pre-registry parallel_for contract (and
        # device_parallel_for), so `except ValueError` keeps working.
        raise ValueError(
            f"unknown scheduler {name!r}; registered: "
            f"{', '.join(available_schedulers())}") from None
    return cls()


def available_schedulers() -> tuple:
    """Registered policy names, sorted."""
    return tuple(sorted(_REGISTRY))
