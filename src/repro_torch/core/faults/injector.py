"""FaultInjector: turns a :class:`FaultPlan` into hook decisions.

Every decision routes through :meth:`FaultInjector._rand` — a keyed hash
of ``(plan.seed, site, *coordinates)`` — so outcomes are deterministic
under any thread interleaving; the only mutable state is attempt/sequence
counters (how many times a poisoned rid has been retried, the global
page-allocation sequence number), each guarded by one lock.

The hooks are the injection surface the rest of the stack calls:

* ``for_layer(layer)`` — the ParallelFor claim boundary.  Returns None
  when no spec targets the layer (the disabled path wraps nothing), else
  a :class:`LayerFaults` whose ``wrap(task)`` raises / stalls / crashes
  per the plan and accumulates the stall ledger that
  ``parallel_for_stats`` copies into ``ScheduleStats.injected_stall_s``.
* ``check_admission(rid)`` / ``check_decode(rid, step)`` /
  ``check_draft(rid, step)`` — the serve engine's per-request
  boundaries; raise :class:`RequestPoisoned`.
* ``page_alloc_should_fail(n)`` — consulted by
  :class:`repro_torch.serve.paged_cache.PageAllocator` before handing out
  pages; True simulates pool pressure.
* ``engine_stall(tick)`` — the decode-loop straggler hook; returns the
  seconds charged (0.0 almost always).
* ``corrupt_artifacts()`` — applies :class:`CorruptArtifact` specs on
  demand (torn writes over tuning/calibration files).
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path
from typing import Callable, List, Optional

from repro_torch.core.faults.plan import (CorruptArtifact, DecodeStall, FaultPlan,
                                    PageFailure, PoisonRequest, TaskFault,
                                    WorkerCrash, WorkerStall)
from repro_torch.core.runtime.pool import WorkerAbort

__all__ = ["FaultInjector", "InjectedFault", "LayerFaults", "RequestPoisoned"]


class InjectedFault(RuntimeError):
    """Base of every deliberately injected failure (task faults, poisoned
    requests).  Kept a plain RuntimeError subclass so un-instrumented
    error handling treats injected faults exactly like organic ones —
    the point of injecting them."""


class RequestPoisoned(InjectedFault):
    """An injected per-request failure at a serve boundary."""

    def __init__(self, rid: int, site: str):
        super().__init__(f"injected poison: request {rid} at {site}")
        self.rid = rid
        self.site = site


class LayerFaults:
    """One layer's claim-boundary faults for one ParallelFor run.

    ``wrap(task)`` is built once per run; its stall/fired ledgers are
    thread-safe (claims race across pool workers) and read back by
    ``parallel_for_stats`` after the scheduler drains."""

    def __init__(self, inj: "FaultInjector", layer: str, call: int,
                 specs: List) -> None:
        self._inj = inj
        self._layer = layer
        self._call = call
        self._specs = specs
        self._lock = threading.Lock()
        self.stall_s = 0.0
        self.fired = 0

    def wrap(self, task: Callable[[int], None]) -> Callable[[int], None]:
        inj, layer, call = self._inj, self._layer, self._call

        def faulted(i: int) -> None:
            for k, sp in enumerate(self._specs):
                if not (i in sp.indices
                        or (sp.p > 0.0
                            and inj._rand(layer, call, k, i) < sp.p)):
                    continue
                if isinstance(sp, WorkerStall):
                    inj.clock.sleep(sp.duration_s)
                    with self._lock:
                        self.stall_s += sp.duration_s
                elif isinstance(sp, WorkerCrash):
                    with self._lock:
                        self.fired += 1
                    raise WorkerAbort(
                        f"injected worker crash at {layer}[{i}]")
                else:
                    with self._lock:
                        self.fired += 1
                    raise InjectedFault(
                        f"injected task fault at {layer}[{i}]")
            task(i)

        return faulted


class FaultInjector:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.clock = plan.clock
        self._lock = threading.Lock()
        self._layer_calls: dict = {}
        self._poison_hits: dict = {}
        self._alloc_seq = 0
        self._alloc_fired = [0] * len(plan.specs)

    # ------------------------------------------------------------- decisions

    def _rand(self, *key) -> float:
        """Deterministic uniform [0, 1) keyed on the plan seed and ``key``
        — stable across processes and thread interleavings (unlike a
        shared RNG stream, whose draw order the OS scheduler would set)."""
        raw = repr((self.plan.seed,) + key).encode()
        digest = hashlib.blake2b(raw, digest_size=8).digest()
        return int.from_bytes(digest, "big") / 2.0 ** 64

    # ------------------------------------------------- ParallelFor boundary

    def for_layer(self, layer: str) -> Optional[LayerFaults]:
        """The layer's claim-boundary faults for the next run, or None when
        no spec targets it (callers then wrap nothing — the zero-overhead
        contract)."""
        specs = [sp for sp in self.plan.specs
                 if isinstance(sp, (TaskFault, WorkerStall, WorkerCrash))
                 and sp.layer == layer]
        if not specs:
            return None
        with self._lock:
            call = self._layer_calls.get(layer, 0)
            self._layer_calls[layer] = call + 1
        return LayerFaults(self, layer, call, specs)

    # ------------------------------------------------------ serve boundaries

    def _poison(self, rid: int, site: str, step: int = 0) -> None:
        for k, sp in enumerate(self.plan.specs):
            if not isinstance(sp, PoisonRequest) or sp.site != site:
                continue
            if not (rid in sp.rids
                    or (sp.p > 0.0 and self._rand("poison", site, k, rid,
                                                  step) < sp.p)):
                continue
            if (site in ("decode", "draft") and sp.steps
                    and step not in sp.steps):
                continue
            with self._lock:
                hits = self._poison_hits.get((k, rid), 0)
                if hits >= sp.times:
                    continue
                self._poison_hits[(k, rid)] = hits + 1
            raise RequestPoisoned(rid, site)

    def check_admission(self, rid: int) -> None:
        """Raise :class:`RequestPoisoned` if this admission attempt of
        ``rid`` is poisoned (the first ``times`` attempts per spec)."""
        self._poison(rid, "admission")

    def check_decode(self, rid: int, step: int) -> None:
        """Raise if ``rid``'s decode ``step`` (1-based token index) is
        poisoned."""
        self._poison(rid, "decode", step)

    def check_draft(self, rid: int, step: int) -> None:
        """Raise if ``rid``'s draft proposals for the tick that would emit
        token ``step`` are poisoned.  The speculative engine catches this
        and degrades the slot's tick to non-speculative decode (k=0): the
        request survives, it only loses the amortization."""
        self._poison(rid, "draft", step)

    # -------------------------------------------------------- page allocator

    def page_alloc_should_fail(self, n: int) -> bool:
        """True when this allocation (by global sequence number) must
        report pressure even though pages may be free."""
        specs = [(k, sp) for k, sp in enumerate(self.plan.specs)
                 if isinstance(sp, PageFailure)]
        if not specs:
            return False
        with self._lock:
            seq = self._alloc_seq
            self._alloc_seq += 1
            for k, sp in specs:
                if self._alloc_fired[k] >= sp.times:
                    continue
                if seq in sp.allocs or (
                        sp.p > 0.0 and self._rand("palloc", k, seq) < sp.p):
                    self._alloc_fired[k] += 1
                    return True
        return False

    # ---------------------------------------------------------- decode clock

    def engine_stall(self, tick: int) -> float:
        """Stall the decode loop per any matching :class:`DecodeStall`;
        returns the seconds charged (for the serve report's ledger)."""
        total = 0.0
        for k, sp in enumerate(self.plan.specs):
            if not isinstance(sp, DecodeStall):
                continue
            if tick in sp.ticks or (
                    sp.p > 0.0 and self._rand("dstall", k, tick) < sp.p):
                total += self.clock.sleep(sp.duration_s)
        return total

    # ------------------------------------------------------------- artifacts

    def corrupt_artifacts(self) -> List[Path]:
        """Apply every :class:`CorruptArtifact` spec (torn-write the file);
        returns the corrupted paths."""
        out = []
        for sp in self.plan.specs:
            if not isinstance(sp, CorruptArtifact):
                continue
            p = Path(sp.path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(sp.garbage)
            out.append(p)
        return out
