"""Per-request and per-run serving telemetry.

Serving is a ParallelFor wearing a trenchcoat, and its telemetry mirrors
:class:`~repro_torch.core.schedulers.ScheduleStats`: admission FAAs are the sync
term, slot idle time is the imbalance term, and the per-request latencies
are the end-to-end cost the paper's model prices.  ``ticks`` count decode
steps (the engine's discrete clock — platform-independent, so tests can
assert on them); ``*_s`` fields are wall-clock seconds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.schedulers import ScheduleStats


@dataclasses.dataclass
class RequestTelemetry:
    """One request's life: queued -> admitted (prefill) -> decoded -> done."""

    rid: int
    prompt_len: int
    submit_tick: int = 0
    admit_tick: int = -1          # decode tick at which prefill ran
    finish_tick: int = -1
    ttft_s: float = float("nan")  # submit -> first token, wall seconds
    finish_s: float = float("nan")
    decode_tokens: int = 0
    stolen: bool = False          # admitted via slot steal, not its own plan
    prefill_tokens: int = 0       # tokens actually run through prefill
    prefix_hit_tokens: int = 0    # prompt tokens served from shared pages
    deferred_ticks: int = 0       # refill passes bounced on page pressure
    # ---- degradation telemetry (defaults = the no-fault fast path) ----
    # terminal status: "ok" (completed), "failed" (poisoned / deadline /
    # pressure-failed), "shed" (load-shed before admission).  The engine
    # assigns exactly one terminal status per request — the chaos
    # differential's no-lost-request invariant.
    status: str = "ok"
    fail_reason: str = ""         # why a failed/shed request ended
    retries: int = 0              # re-admissions after cancel/poison
    # ---- speculative-decoding telemetry (zeros when speculation is off) ----
    drafted_tokens: int = 0       # drafter proposals made for this request
    accepted_tokens: int = 0      # proposals emitted (matched target greedy)

    @property
    def queue_wait_ticks(self) -> int:
        """Decode steps spent waiting for a slot (the contended-admission
        analogue of FAA queueing delay)."""
        return max(0, self.admit_tick - self.submit_tick)

    @property
    def latency_s(self) -> float:
        return self.finish_s

    @property
    def decode_tokens_per_s(self) -> float:
        d = self.finish_s - self.ttft_s
        return self.decode_tokens / d if d > 0 else float("nan")


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one serve() run — the row the admission sweep prints."""

    schedule: str
    mode: str
    slots: int
    n_requests: int
    total_ticks: int
    wall_s: float
    total_tokens: int
    admission: Optional[ScheduleStats]
    admission_steals: int
    requests: List[RequestTelemetry] = dataclasses.field(default_factory=list)
    # ----- paged-cache telemetry (zeros under the contiguous backend) -----
    cache: str = "contiguous"       # ServeConfig.cache that produced the run
    num_pages: int = 0              # pool size (0 = not paged)
    pages_allocated: int = 0        # free-list claims over the whole run
    pages_freed: int = 0
    peak_pages_live: int = 0
    prefix_hits: int = 0            # admissions that reused >= 1 shared page
    prefix_hit_tokens: int = 0      # prompt tokens never re-prefilled
    prefill_tokens: int = 0         # prompt tokens actually computed
    deferred_admissions: int = 0    # refill passes bounced on page pressure
    # every page-claim ParallelFor's ScheduleStats (the pool free list run
    # under the admission policy — the paper's FAA counter, per claim)
    page_alloc_stats: List[ScheduleStats] = dataclasses.field(
        default_factory=list)
    # ----- degradation telemetry (zeros outside a fault_scope) -----
    failed_requests: int = 0        # terminal FAILED (poison/deadline/pressure)
    shed_requests: int = 0          # terminal SHED (load shedding)
    retries: int = 0                # total re-admissions across requests
    # exposed wait charged by injected stalls: engine decode-loop stalls
    # plus every stall inside this run's admission / page-claim
    # ParallelFors — the measured analogue of the cost model's
    # contention/FAA-wait term (see docs/robustness.md)
    injected_stall_s: float = 0.0
    # ----- speculative-decoding telemetry (zeros when speculation is off) ----
    spec_k: int = 0                 # draft span (0 = non-speculative run)
    drafted_tokens: int = 0         # drafter proposals across the run
    accepted_tokens: int = 0        # proposals emitted (matched target greedy)
    draft_degraded_ticks: int = 0   # (slot, tick) pairs degraded to k=0
    # (live slot, tick) pairs: each is one unit of per-token decode
    # bookkeeping — the slot's claim on the tick, the serving analogue of
    # the per-item FAA.  Speculation emits >1 token per pair; that ratio
    # is the paper's amortization, measured (see faa_per_token).
    decode_slot_ticks: int = 0

    @property
    def wasted_tokens(self) -> int:
        """Drafted but rejected proposals: drafted = accepted + wasted."""
        return self.drafted_tokens - self.accepted_tokens

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafter proposals the target verified and emitted."""
        if self.drafted_tokens == 0:
            return float("nan")
        return self.accepted_tokens / self.drafted_tokens

    @property
    def faa_per_token(self) -> float:
        """Shared-counter hits + per-slot-tick bookkeeping per emitted
        token — the amortization headline: admission FAAs, page-claim
        FAAs, and one decode bookkeeping event per (live slot, tick).
        Non-speculative decode pays >= 1 per token by construction;
        speculation divides the slot-tick term by the accepted span."""
        if self.total_tokens == 0:
            return float("nan")
        ops = ((self.admission.faa_total if self.admission else 0)
               + self.page_alloc_faa_total + self.decode_slot_ticks)
        return ops / self.total_tokens

    @property
    def page_alloc_faa_shared(self) -> int:
        return sum(s.faa_shared for s in self.page_alloc_stats)

    @property
    def page_alloc_faa_total(self) -> int:
        return sum(s.faa_total for s in self.page_alloc_stats)

    @property
    def ok_requests(self) -> int:
        return self.n_requests - self.failed_requests - self.shed_requests

    @property
    def survival_rate(self) -> float:
        """Fraction of submitted requests that completed OK."""
        if self.n_requests == 0:
            return 1.0
        return self.ok_requests / self.n_requests

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        """q-th percentile of per-request wall latency (seconds)."""
        lats = [r.latency_s for r in self.requests
                if np.isfinite(r.latency_s)]
        return float(np.percentile(lats, q)) if lats else float("nan")

    @property
    def mean_queue_wait_ticks(self) -> float:
        if not self.requests:
            return 0.0
        return float(np.mean([r.queue_wait_ticks for r in self.requests]))

    def as_row(self) -> dict:
        """Flat dict for benchmark CSVs (shared-FAA columns included)."""
        adm = self.admission
        return {
            "schedule": self.schedule,
            "mode": self.mode,
            "slots": self.slots,
            "requests": self.n_requests,
            "total_tokens": self.total_tokens,
            "ticks": self.total_ticks,
            "wall_s": round(self.wall_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "p50_latency_s": round(self.latency_percentile(50), 4),
            "p95_latency_s": round(self.latency_percentile(95), 4),
            "mean_queue_wait_ticks": round(self.mean_queue_wait_ticks, 2),
            "admission_faa_shared": adm.faa_shared if adm else 0,
            "admission_faa_total": adm.faa_total if adm else 0,
            "admission_steals": self.admission_steals
                                + (adm.steals if adm else 0),
            "cache": self.cache,
            "num_pages": self.num_pages,
            "pages_allocated": self.pages_allocated,
            "peak_pages_live": self.peak_pages_live,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens": self.prefill_tokens,
            "deferred_admissions": self.deferred_admissions,
            "page_faa_shared": self.page_alloc_faa_shared,
            "page_faa_total": self.page_alloc_faa_total,
            "ok": self.ok_requests,
            "failed": self.failed_requests,
            "shed": self.shed_requests,
            "retries": self.retries,
            "injected_stall_s": round(self.injected_stall_s, 4),
            "spec_k": self.spec_k,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "wasted_tokens": self.wasted_tokens,
            "acceptance_rate": round(self.acceptance_rate, 4)
                               if self.drafted_tokens else float("nan"),
            "decode_slot_ticks": self.decode_slot_ticks,
            "faa_per_token": round(self.faa_per_token, 4)
                             if self.total_tokens else float("nan"),
            "draft_degraded_ticks": self.draft_degraded_ticks,
        }
