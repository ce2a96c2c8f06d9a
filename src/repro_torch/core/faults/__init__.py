"""Seeded, deterministic fault injection for the runtime + serve stack.

The paper measures what the atomic FAA *costs*; this package measures what
its uniformity *hides*: one shared claim point couples every worker's
failure fate as tightly as its latency.  A :class:`FaultPlan` describes a
chaos run declaratively — task exceptions and stalls at the ParallelFor
claim boundary, worker crashes, poisoned serve requests, forced
page-allocation pressure, torn artifact writes — and every injection
decision is a keyed hash of the plan seed, so a chaos run reproduces
bit-for-bit from ``(seed, specs)`` alone.

Installation is scoped and process-wide::

    from repro_torch.core import faults

    plan = faults.FaultPlan(seed=7, specs=[
        faults.PoisonRequest(rids=(3,), times=10**6),
        faults.WorkerStall(layer="serve", p=0.05, duration_s=0.002),
    ])
    with faults.fault_scope(plan) as inj:
        engine.serve(prompts, 16)

Zero overhead when disabled is a hard contract: with no plan installed,
:func:`active` returns None, every hook site sees that one ``None`` at its
*call/construction* boundary (``parallel_for_stats`` per call, the serve
engine per ``serve()``, the page allocator per allocation batch) and wraps
nothing — no per-claim or per-token branch exists on the hot path.  The
degradation tests assert byte-identical behavior with hooks disabled.

Port of ``repro.core.faults``.  In the port the plan is read by
``parallel_for_stats``, ``PageAllocator.try_alloc`` and the serve engine
(``serve/engine.py``: poisoned admissions, decode steps and drafts,
decode stalls, retries with backoff, deadlines, shedding under page
pressure).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

from repro_torch.core.faults.clock import ChaosClock
from repro_torch.core.faults.injector import (FaultInjector, InjectedFault,
                                        LayerFaults, RequestPoisoned)
from repro_torch.core.faults.plan import (CorruptArtifact, DecodeStall, FaultPlan,
                                    PageFailure, PoisonRequest, TaskFault,
                                    WorkerCrash, WorkerStall)
from repro_torch.core.runtime.pool import WorkerAbort

__all__ = [
    "ChaosClock",
    "CorruptArtifact",
    "DecodeStall",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "LayerFaults",
    "PageFailure",
    "PoisonRequest",
    "RequestPoisoned",
    "TaskFault",
    "WorkerAbort",
    "WorkerCrash",
    "WorkerStall",
    "active",
    "clear",
    "fault_scope",
    "install",
]

_LOCK = threading.Lock()
_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    """The installed injector, or None (the common case — every hook site
    gates on this one read)."""
    return _ACTIVE


def install(plan: Union[FaultPlan, FaultInjector]) -> FaultInjector:
    """Install a plan (or a pre-built injector) process-wide; returns the
    active injector.  Prefer :func:`fault_scope` — an injector left
    installed poisons every later run in the process."""
    global _ACTIVE
    inj = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    with _LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(
                "a fault plan is already installed; nest fault_scope "
                "blocks is not supported — compose one plan instead")
        _ACTIVE = inj
    return inj


def clear() -> None:
    """Remove the installed injector (idempotent)."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


@contextlib.contextmanager
def fault_scope(plan: Union[FaultPlan, FaultInjector]):
    """Install ``plan`` for the dynamic extent of the block."""
    inj = install(plan)
    try:
        yield inj
    finally:
        clear()
