"""The measured search: time model-pruned candidates on the live backend.

Port of ``repro.core.autotune_search.search``; the walk is the
reference's.  The analytic model proposes (top-k candidates ranked by
``Cost(T,N,L)`` with the tuning context's L); the clock disposes.  Each
candidate is run ``warmup`` times untimed, then timed ``reps`` times and
scored by its median.  The candidate list is walked best-analytic first,
so the prior's pick is always measured (the search can only match or beat
it) and the walk early-stops once a candidate beats it by a stable margin
with no recent improvement.

On the card a sample is not one call under the host's clock: a 30 us
kernel timed that way measures its launch.  A runner on the card
(``runner.on_cuda``) cycles its own input sets, together larger than the
50 MB L2, and one sample is CUDA events around ``runner.calls`` calls
queued behind a sleep kernel (so the host's launch time does not show as
gaps), divided by the count.  Elsewhere (the CPU, where the runners time
the plain versions) a sample is one call on the host clock.

Every sample bumps a process-wide measurement counter
(:func:`measurement_count`) once — the observable that lets tests *assert*
that warm-db lookups do zero measurements instead of trusting that they do.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["SearchOptions", "SearchResult", "Trial", "measurement_count",
           "run_search", "time_runner"]

_COUNT_LOCK = threading.Lock()
_MEASUREMENTS = 0


def measurement_count() -> int:
    """Total timed samples this process has taken."""
    return _MEASUREMENTS


def _bump() -> None:
    global _MEASUREMENTS
    with _COUNT_LOCK:
        _MEASUREMENTS += 1


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    """Knobs of the measured search (the reference's defaults)."""

    top_k: int = 8        # analytic prior keeps this many candidates
    warmup: int = 1       # untimed runs per candidate (compile + caches)
    reps: int = 3         # timed runs per candidate; median wins
    margin: float = 0.10  # "beats the analytic pick" = >10% faster
    patience: int = 2     # non-improving candidates before early stop


@dataclasses.dataclass(frozen=True)
class Trial:
    config: dict
    median_s: float


@dataclasses.dataclass(frozen=True)
class SearchResult:
    kernel: str
    backend: str
    bucket: str
    config: dict            # the measured winner
    measured_s: float
    analytic_config: dict   # the model's pick (always measured first)
    analytic_s: float
    n_timed: int            # timed runs spent on this search
    trials: tuple[Trial, ...]

    @property
    def speedup(self) -> float:
        """Analytic-pick latency over the winner's (>= 1 by construction)."""
        return self.analytic_s / max(self.measured_s, 1e-12)


# the sleep that holds the stream while a sample's calls are queued:
# ~20 ms at the H100's 1.98 GHz, far longer than queueing them takes
_HOLD_CYCLES = 40_000_000


def _cuda_sample(runner: Callable[[], None], calls: int) -> float:
    """Device seconds per call of ``calls`` back-to-back calls."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_HOLD_CYCLES)
    start.record()
    for _ in range(calls):
        runner()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def time_runner(runner: Callable[[], None], *, warmup: int,
                reps: int) -> float:
    """Median seconds per call of ``reps`` timed samples after ``warmup``
    untimed calls: on the card CUDA events over ``runner.calls`` calls a
    sample, elsewhere the host clock around one."""
    for _ in range(max(0, warmup)):
        runner()
    on_cuda = getattr(runner, "on_cuda", False)
    calls = max(1, int(getattr(runner, "calls", 1)))
    samples = []
    for _ in range(max(1, reps)):
        if on_cuda:
            samples.append(_cuda_sample(runner, calls))
        else:
            t0 = time.perf_counter()
            runner()
            samples.append(time.perf_counter() - t0)
        _bump()
    return float(np.median(samples))


def run_search(
    *,
    kernel: str,
    backend: str,
    bucket: str,
    candidates: Sequence[dict],
    make_runner: Callable[[dict], Callable[[], None]],
    options: Optional[SearchOptions] = None,
) -> SearchResult:
    """Walk ``candidates`` (analytic-best first) and return the winner.

    ``make_runner(config)`` must return a thunk executing the kernel once
    on pre-built inputs (the runner factory owns input construction so the
    arrays are materialized once per search, not per candidate).
    """
    opts = options or SearchOptions()
    cands = list(candidates)
    if not cands:
        raise ValueError(f"{kernel}: empty candidate set for bucket {bucket}")
    # never truncate below the first two slots: slot 0 is the prior's
    # pick, slot 1 the classic fallback (kernels._with_classic)
    # — a top_k=1 cut would let a recorded winner lose to what a cache
    # miss actually runs
    cands = cands[:max(2 if len(cands) > 1 else 1, opts.top_k)]
    start_count = measurement_count()
    trials: list[Trial] = []
    best_cfg: Optional[dict] = None
    best_t = float("inf")
    analytic_t = float("inf")
    since_improve = 0
    for i, cfg in enumerate(cands):
        t = time_runner(make_runner(cfg), warmup=opts.warmup,
                        reps=opts.reps)
        trials.append(Trial(dict(cfg), t))
        if i == 0:
            analytic_t = t
        if t < best_t:
            best_cfg, best_t = dict(cfg), t
            since_improve = 0
        else:
            since_improve += 1
        beats_analytic = best_t <= analytic_t * (1.0 - opts.margin)
        if beats_analytic and since_improve >= opts.patience:
            break  # stable winner well past the model's pick
    assert best_cfg is not None
    return SearchResult(
        kernel=kernel, backend=backend, bucket=bucket, config=best_cfg,
        measured_s=best_t, analytic_config=dict(cands[0]),
        analytic_s=analytic_t,
        n_timed=measurement_count() - start_count, trials=tuple(trials))
