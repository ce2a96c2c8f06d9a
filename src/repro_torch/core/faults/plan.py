"""FaultPlan: the declarative, seeded description of a chaos run.

A plan is a seed plus a tuple of fault specs.  Every injection decision is
a pure function of ``(seed, site, coordinates)`` — a keyed hash, not a
shared RNG stream — so two runs of the same plan against the same workload
inject the *identical* faults regardless of thread interleaving, and a
failing chaos run reproduces from its seed alone.  That determinism is
what lets the degradation tests hard-assert survivor bit-identity against
a no-fault run instead of eyeballing flaky wreckage.

The spec taxonomy (see ``docs/robustness.md``):

==================  =======================================================
spec                injects
==================  =======================================================
:class:`TaskFault`   an exception from ``task(i)`` at the ParallelFor claim
                     boundary (layer-targeted: ``parallel_for``, ``serve``,
                     ``paged_alloc``, ``data`` …)
:class:`WorkerStall` a straggler — ``task(i)`` stalls for ``duration_s``
                     through the plan's :class:`ChaosClock`; the stall is
                     charged to ``ScheduleStats.injected_stall_s``
:class:`WorkerCrash` death of the pool worker running ``task(i)`` (raises
                     :class:`repro_torch.core.runtime.pool.WorkerAbort`); the
                     WorkerPool must survive and re-converge
:class:`PoisonRequest` a per-request failure at the serve engine's
                     admission, decode, or draft boundary (``times``
                     attempts fail, then the request behaves — the
                     retry-policy probe; a poisoned *draft* degrades the
                     tick to non-speculative decode instead of failing)
:class:`PageFailure` a forced page-allocation failure: ``try_alloc``
                     reports pressure even when pages are free (the load-
                     shedding / deferral-aging probe)
:class:`DecodeStall` a straggler decode tick in the serve engine, charged
                     to ``ServeReport.injected_stall_s``
:class:`CorruptArtifact` a torn write over a persisted artifact
                     (tuning db / calibration) — applied on demand via
                     ``FaultInjector.corrupt_artifacts()``
==================  =======================================================
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.faults.clock import ChaosClock

__all__ = [
    "CorruptArtifact",
    "DecodeStall",
    "FaultPlan",
    "PageFailure",
    "PoisonRequest",
    "TaskFault",
    "WorkerCrash",
    "WorkerStall",
]


@dataclasses.dataclass(frozen=True)
class TaskFault:
    """Raise from ``task(i)`` in ParallelFor runs tagged ``layer``.

    Fires for every ``i`` in ``indices``, plus each remaining iteration
    independently with probability ``p`` (keyed on the plan seed, the
    layer, the call number, and ``i`` — deterministic)."""

    layer: str = "parallel_for"
    p: float = 0.0
    indices: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class WorkerStall:
    """Stall ``task(i)`` for ``duration_s`` (a straggler, not a failure)."""

    layer: str = "parallel_for"
    p: float = 0.0
    indices: Tuple[int, ...] = ()
    duration_s: float = 0.002


@dataclasses.dataclass(frozen=True)
class WorkerCrash:
    """Kill the persistent pool worker running ``task(i)``."""

    layer: str = "parallel_for"
    p: float = 0.0
    indices: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PoisonRequest:
    """Fail a serve request at ``site`` (``admission`` | ``decode`` |
    ``draft``).

    Targets the rids in ``rids`` plus others with probability ``p``.  The
    first ``times`` attempts at the site raise
    :class:`~repro_torch.core.faults.injector.RequestPoisoned`; later attempts
    succeed — so ``times <= max_retries`` probes the retry path and
    ``times`` large forces a terminal FAILED.  For ``site="decode"`` and
    ``site="draft"``, ``steps`` names the decode steps (1-based token
    index) that fail; empty = every step.  ``site="draft"`` poisons the
    *drafter's* proposals for that slot/tick: the speculative engine
    degrades the tick to non-speculative decode (k=0) — the request
    survives, it just loses the amortization."""

    rids: Tuple[int, ...] = ()
    p: float = 0.0
    times: int = 1_000_000
    site: str = "admission"
    steps: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PageFailure:
    """Force ``PageAllocator.try_alloc`` to report page pressure.

    Fires on the allocation sequence numbers in ``allocs`` plus others
    with probability ``p``, at most ``times`` in total."""

    p: float = 0.0
    allocs: Tuple[int, ...] = ()
    times: int = 1_000_000


@dataclasses.dataclass(frozen=True)
class DecodeStall:
    """Stall the engine's decode loop at matching ticks (a straggler
    decode step — the serving face of the paper's slow-claim regime)."""

    p: float = 0.0
    ticks: Tuple[int, ...] = ()
    duration_s: float = 0.002


@dataclasses.dataclass(frozen=True)
class CorruptArtifact:
    """Overwrite the artifact at ``path`` with a torn-write prefix.

    Not self-firing: the harness applies it between phases via
    ``FaultInjector.corrupt_artifacts()`` — mid-run artifact corruption is
    an *external* event, not something the hot path should poll for."""

    path: str = ""
    garbage: str = '{"kind": "tru'      # a torn JSON write


@dataclasses.dataclass
class FaultPlan:
    """A seeded chaos run: ``seed`` keys every injection decision."""

    seed: int = 0
    specs: Tuple = ()
    clock: ChaosClock = dataclasses.field(default_factory=ChaosClock)

    def __post_init__(self):
        self.specs = tuple(self.specs)
        for sp in self.specs:
            if isinstance(sp, PoisonRequest) and sp.site not in (
                    "admission", "decode", "draft"):
                raise ValueError(
                    f"PoisonRequest.site must be 'admission', 'decode' or "
                    f"'draft', got {sp.site!r}")

    def describe(self) -> str:
        """One-line summary for chaos tables / logs."""
        names = [type(sp).__name__ for sp in self.specs]
        return f"seed={self.seed}:" + "+".join(names or ["none"])
