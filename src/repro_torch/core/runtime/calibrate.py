"""Online FAA-cost calibration: measure ``L(A,S)`` where the code runs,
refit the cost model, and expose the result to every granularity knob.

Port of ``repro.core.runtime.calibrate``.  The host measurements, the
simulator sweep and the persisted artifact are the reference's; the refit
(:func:`repro_torch.core.cost_model.train_cost_model`) runs in torch, on
the card unless the caller passes ``device="cpu"``.  A calibration file
written by either package loads in the other (the same envelope, kind,
version and field names); the port's default file is
``results/calibration_torch.json`` (see :mod:`repro_torch.core.runtime`),
so the two packages' host snapshots never overwrite each other.

The paper fits its rational block-size model ``B = (αG+δ₀)/(β·x+δ₁)`` on
one machine and publishes the weights; Schweizer, Besta & Hoefler (2020)
show contended-atomic latency varies by an order of magnitude across
architectures, so those weights are a *platform snapshot*, not a law.
This module closes the loop on the live host:

1. **Microbenchmark** the paper's cost drivers: uncontended FAA round-trip
   latency, contended (ownership-transfer) FAA latency, and per-item task
   dispatch cost (`measure_host`).  On a 1-core CI container the transfer
   measurement is meaningless; the measured local latency is kept and the
   transfer ratios fall back to the simulator's topology constants.
2. **Generate training points** by sweeping the discrete-event simulator
   (:mod:`repro_torch.core.atomic_sim`) over the paper's three platforms —
   plus a topology built from the live host's measurements when available —
   recording the empirically best block size per (topology, threads,
   unit-task) cell.
3. **Refit** the rational model's coefficients on those measured/simulated
   points with :func:`repro_torch.core.cost_model.train_cost_model` (never
   the published weights).
4. **Persist** everything to the calibration file and wrap it in a
   :class:`TuningContext` — the one object the data-pipeline grain, the
   ``cost_model`` scheduler, serve admission batching and the speculative
   draft span, autotune block choice and the kernel search's dispatch
   prior and the trainer's microbatch count all consult.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import atomic_sim, cost_model as cm
from repro_torch.core.atomic_sim import UnitTask
from repro_torch.core.runtime.artifacts import load_artifact, save_artifact
from repro_torch.core.schedulers.base import AtomicCounter
from repro_torch.core.topology import (AMD3970X, GOLD5225R, W3225R,
                                       CoreGroup, CpuTopology, GpuTopology,
                                       h100_topology)

__all__ = [
    "HostMeasurement",
    "TuningContext",
    "default_context",
    "load_calibration",
    "measure_host",
    "ranking_consistency",
    "run_calibration",
    "save_calibration",
]

# Local FAA latency of the reference platform in simulator clocks — the
# anchor that converts measured nanoseconds into the simulator's abstract
# clock domain (1 host-local FAA == W3225R's local FAA by definition).
_REF_LOCAL_CLOCKS = W3225R.r_same_core + W3225R.e_faa + W3225R.o_misc


# ---------------------------------------------------------------------------
# Host microbenchmarks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostMeasurement:
    """Raw host timings (nanoseconds) behind a calibration."""

    faa_ns: float             # uncontended FAA round-trip
    transfer_ns: float        # contended FAA (ownership transfer included)
    dispatch_ns: float        # per-item task dispatch (python call)
    cores: int
    transfer_measured: bool   # False = 1-core fallback ratios in use

    def local_clocks(self) -> float:
        """The host's local FAA expressed in simulator clocks (anchor)."""
        return _REF_LOCAL_CLOCKS

    def ns_per_clock(self) -> float:
        return max(self.faa_ns, 1e-3) / _REF_LOCAL_CLOCKS

    def transfer_clocks(self) -> float:
        return self.transfer_ns / self.ns_per_clock()

    def dispatch_clocks(self) -> float:
        return self.dispatch_ns / self.ns_per_clock()


def _time_ns(fn, iters: int) -> float:
    t0 = time.perf_counter_ns()
    fn(iters)
    return (time.perf_counter_ns() - t0) / max(1, iters)


def measure_faa_ns(iters: int = 200_000) -> float:
    """Uncontended fetch-and-add round trip on this host, ns/op."""
    counter = AtomicCounter()

    def loop(k: int) -> None:
        faa = counter.fetch_and_add
        for _ in range(k):
            faa(1)

    loop(1000)  # warm
    return _time_ns(loop, iters)


def measure_transfer_ns(iters: int = 50_000, threads: int = 2) -> Optional[float]:
    """Contended FAA latency: ``threads`` hammering one counter, ns/op.

    The delta over :func:`measure_faa_ns` approximates the cache-line
    ownership transfer ``R(S)``.  Returns None on hosts with fewer cores
    than ``threads`` (the measurement would time GIL churn, not coherence
    traffic).
    """
    if (os.cpu_count() or 1) < threads:
        return None
    counter = AtomicCounter()
    start = threading.Event()

    def worker() -> None:
        start.wait()
        faa = counter.fetch_and_add
        for _ in range(iters):
            faa(1)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    t0 = time.perf_counter_ns()
    start.set()
    for t in ts:
        t.join()
    return (time.perf_counter_ns() - t0) / (iters * threads)


def measure_dispatch_ns(iters: int = 200_000) -> float:
    """Per-item cost of dispatching a trivial ``task(i)`` — the python
    analogue of the paper's per-iteration functor call."""
    sink = np.zeros(1, np.int64)

    def task(i: int) -> None:
        sink[0] += i

    def loop(k: int) -> None:
        for i in range(k):
            task(i)

    loop(1000)
    return _time_ns(loop, iters)


def measure_host() -> HostMeasurement:
    """Run all host microbenchmarks once."""
    faa_ns = measure_faa_ns()
    transfer = measure_transfer_ns()
    if transfer is None or transfer <= faa_ns:
        # 1-core container (or no observable contention): keep the measured
        # local latency, take the transfer *ratio* from the reference
        # platform's topology constants.
        ratio = ((W3225R.r_same_group + W3225R.e_faa + W3225R.o_misc)
                 / _REF_LOCAL_CLOCKS)
        return HostMeasurement(
            faa_ns=faa_ns, transfer_ns=faa_ns * ratio,
            dispatch_ns=measure_dispatch_ns(),
            cores=os.cpu_count() or 1, transfer_measured=False)
    return HostMeasurement(
        faa_ns=faa_ns, transfer_ns=float(transfer),
        dispatch_ns=measure_dispatch_ns(),
        cores=os.cpu_count() or 1, transfer_measured=True)


def host_topology(meas: HostMeasurement) -> CpuTopology:
    """A :class:`CpuTopology` for the live host, with the coherence terms
    rescaled so the simulator reproduces the *measured* FAA latencies.

    Cores land in groups of 8 (the common L3 slice width); with no way to
    probe the real cache hierarchy portably, the split only matters for
    the same-group/cross-group ratio, which the measured transfer anchors.
    """
    cores = max(1, meas.cores)
    group_w = min(8, cores)
    groups = tuple(CoreGroup(group_w)
                   for _ in range(max(1, -(-cores // group_w))))
    same_group_r = max(
        W3225R.r_same_core,
        meas.transfer_clocks() - W3225R.e_faa - W3225R.o_misc)
    cross_ratio = W3225R.r_cross_group / W3225R.r_same_group
    return CpuTopology(
        name=f"host-{cores}c",
        groups=groups,
        r_same_core=W3225R.r_same_core,
        r_same_group=same_group_r,
        r_cross_group=same_group_r * cross_ratio,
    )


# ---------------------------------------------------------------------------
# TuningContext — the calibration product every layer consults
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuningContext:
    """Platform-calibrated granularity advisor.

    ``params`` are the rational model's coefficients fitted on this
    context's measured/simulated points (or the paper's published weights
    for the ``default`` context).  The FAA terms are in simulator clocks;
    ``dispatch_overhead_s`` is the measured wall-clock per-item dispatch.
    """

    source: str                   # "measured" | "simulated" | "default"
    params: dict
    faa_cost: float               # local FAA, clocks
    faa_same_group: float         # same-L3 transfer FAA, clocks
    faa_remote_cost: float        # EXTRA clocks for a cross-group claim
    per_item_cost: float          # reference per-item dispatch, clocks
    dispatch_overhead_s: float
    host_cores: int
    host_groups: int
    fit_loss: float = float("nan")
    n_points: int = 0

    # ---- the knobs -------------------------------------------------------

    def suggest_block(self, feats: cm.WorkloadFeatures,
                      n: Optional[int] = None) -> int:
        """The learned model's block size under THIS context's weights."""
        return cm.suggest_block_size(feats, n=n, params=self.params)

    def choose_block(self, n: int, workers: int,
                     per_item_cost: Optional[float] = None,
                     *, candidates: Optional[Sequence[int]] = None,
                     jitter: float = 0.35) -> int:
        """Analytic argmin with the calibrated ``L`` instead of a guess."""
        per_item = self.per_item_cost if per_item_cost is None else per_item_cost
        cands = list(candidates) if candidates is not None else [
            2 ** i for i in range(int(np.log2(max(2, n))) + 1)]
        cands = [c for c in cands if 1 <= c <= n] or [1]
        costs = [
            cm.analytic_cost(
                n, c, self.faa_cost, per_item, workers, quota=jitter,
                groups=max(1, self.host_groups),
                faa_remote_cost=self.faa_remote_cost)
            for c in cands
        ]
        return int(cands[int(np.argmin(costs))])

    def admission_block(self, n_requests: int, slots: int) -> int:
        """Requests admitted per shared-counter hit in the serve queue —
        the paper's B lever read as an admission batch.  Clamped by the
        model's own ``B < N/2T`` bound, so small queues stay fully
        dynamic (block 1) and only deep queues amortize admission FAAs."""
        if n_requests <= 0:
            return 1
        feats = cm.WorkloadFeatures(
            core_groups=max(1, self.host_groups), threads=max(1, slots),
            unit_read=4096, unit_write=4096, unit_comp=1024)
        return max(1, self.suggest_block(feats, n=n_requests))

    def draft_span(self, *, acceptance: float = 0.75,
                   draft_cost_ratio: float = 0.25, max_k: int = 4) -> int:
        """Draft tokens proposed per verification in speculative serve —
        the paper's B lever read as an acceptance-span grain, mirroring
        :meth:`admission_block`.  One verify is the unit of work (priced
        at this context's calibrated per-item cost); the per-tick host
        bookkeeping — acceptance scan, length rollback, the shared-counter
        hits — is priced at the calibrated FAA costs (remote share
        weighted by the group count, as in ``analytic_cost``)."""
        verify = max(1e-9, self.per_item_cost)
        groups = max(1, self.host_groups)
        sync = self.faa_cost + self.faa_remote_cost * (groups - 1) / groups
        return cm.best_draft_span(
            acceptance, draft_cost=draft_cost_ratio * verify,
            verify_cost=verify + sync, max_k=max_k)

    def data_grain(self, n_examples: int, *, host_threads: int = 8,
                   bytes_per_example: int = 4 * 4096) -> int:
        """Host data-pipeline grain under the calibrated weights."""
        feats = cm.WorkloadFeatures(
            core_groups=max(1, self.host_groups), threads=host_threads,
            unit_read=bytes_per_example, unit_write=bytes_per_example,
            unit_comp=1024)
        return self.suggest_block(feats, n=n_examples)

    def microbatches(self, global_batch: int, *, grad_bytes: float,
                     topo: GpuTopology = h100_topology(1),
                     step_flops: float = 1e15) -> int:
        """Gradient-accumulation count with the measured dispatch overhead
        as the per-microbatch launch floor (``topo``: by default one
        H100; the trainer passes the cards its rows split over)."""
        from repro_torch.core import autotune   # lazy: it reads runtime

        return autotune.microbatch_count(
            global_batch, grad_bytes=grad_bytes, step_flops=step_flops,
            topo=topo, launch_overhead=max(25e-6, self.dispatch_overhead_s))

    # ---- (de)serialization ----------------------------------------------

    def as_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["params"] = {k: np.asarray(v).tolist()
                       for k, v in self.params.items()}
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "TuningContext":
        d = dict(d)
        d["params"] = {k: np.asarray(v, np.float32)
                       for k, v in d["params"].items()}
        return cls(**d)


def default_context() -> TuningContext:
    """The un-calibrated fallback: published weights + reference-platform
    constants.  Every consumer works; nothing is measured."""
    ref = W3225R
    return TuningContext(
        source="default",
        params={k: np.asarray(v) for k, v in cm.PAPER_WEIGHTS.items()},
        faa_cost=_REF_LOCAL_CLOCKS,
        faa_same_group=ref.r_same_group + ref.e_faa + ref.o_misc,
        faa_remote_cost=ref.r_cross_group - ref.r_same_core,
        per_item_cost=UnitTask().clocks(),
        dispatch_overhead_s=25e-6,
        host_cores=os.cpu_count() or 1,
        host_groups=1,
    )


# ---------------------------------------------------------------------------
# Point generation + fitting
# ---------------------------------------------------------------------------

# Unit tasks spanning the paper's R/W/C axes (powers the normalization
# reacts to: log2 R, log2 W, log1024 C).
_FIT_TASKS = (
    UnitTask(unit_read=64, unit_write=64, unit_comp=1024),
    UnitTask(unit_read=1024, unit_write=1024, unit_comp=1024),
    UnitTask(unit_read=4096, unit_write=1024, unit_comp=1024),
    UnitTask(unit_read=1024, unit_write=16384, unit_comp=64),
    UnitTask(unit_read=1024, unit_write=1024, unit_comp=1024 ** 2),
)
_FIT_TASKS_FAST = _FIT_TASKS[:3]

_PAPER_TOPOLOGIES = (W3225R, GOLD5225R, AMD3970X)


def _threads_for(topo: CpuTopology, fast: bool) -> list[int]:
    total = topo.total_cores
    if fast:
        return sorted({2, total})
    return sorted({2, max(2, total // 4), max(2, total // 2), total})


def generate_points(
    *,
    topologies: Sequence[CpuTopology] = _PAPER_TOPOLOGIES,
    fast: bool = False,
    n: int = 512,
    seeds: int = 1,
) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """Sweep the simulator; return (x [m,5] normalized, y [m] best-B, rows).

    Each row records (topology, threads, task, best block) — one measured
    point of the paper's tables, produced by the event model instead of a
    wall clock.
    """
    tasks = _FIT_TASKS_FAST if fast else _FIT_TASKS
    blocks = [2 ** i for i in range(9)]  # 1..256
    feats, ys, rows = [], [], []
    for topo in topologies:
        for t in _threads_for(topo, fast):
            for task in tasks:
                best = atomic_sim.best_block_size(
                    topo, t, task, n=n, block_sizes=blocks, seeds=seeds)
                f = cm.WorkloadFeatures(
                    core_groups=topo.groups_used(t), threads=t,
                    unit_read=task.unit_read, unit_write=task.unit_write,
                    unit_comp=task.unit_comp)
                feats.append(f.normalized())
                ys.append(float(best))
                rows.append({
                    "topology": topo.name, "threads": t,
                    "unit_read": task.unit_read,
                    "unit_write": task.unit_write,
                    "unit_comp": task.unit_comp, "best_block": best,
                })
    return np.stack(feats), np.asarray(ys, np.float32), rows


def fit_points(x: np.ndarray, y: np.ndarray, *, fast: bool = False,
               steps: Optional[int] = None,
               restarts: Optional[int] = None, seed: int = 0,
               device=None) -> tuple[dict, float]:
    """Refit the rational model on calibration points on ``device`` (the
    card by default); returns (params, final loss).  Never touches the
    published weights."""
    steps = steps if steps is not None else (2_500 if fast else 12_000)
    restarts = restarts if restarts is not None else (4 if fast else 12)
    params, losses = cm.train_cost_model(
        x, y, steps=steps, restarts=restarts, seed=seed, device=device)
    return params, float(losses[-1])


def run_calibration(
    *,
    simulate_only: bool = False,
    fast: bool = False,
    steps: Optional[int] = None,
    restarts: Optional[int] = None,
    n: int = 512,
    seeds: int = 1,
    measurement: Optional[HostMeasurement] = None,
    device=None,
) -> TuningContext:
    """Measure (unless ``simulate_only``), sweep, refit on ``device`` (the
    card by default); returns the resulting :class:`TuningContext`.
    Persisting/installing is the caller's job (see
    :func:`repro_torch.core.runtime.calibrate`).

    ``measurement`` reuses a :class:`HostMeasurement` taken by the caller
    (e.g. the CLI, which reports it) instead of benchmarking twice."""
    meas: Optional[HostMeasurement] = None
    topologies = list(_PAPER_TOPOLOGIES)
    if not simulate_only:
        meas = measurement if measurement is not None else measure_host()
        if meas.cores > 1:
            topologies.append(host_topology(meas))
    x, y, _rows = generate_points(topologies=topologies, fast=fast, n=n,
                                  seeds=seeds)
    params, loss = fit_points(x, y, fast=fast, steps=steps,
                              restarts=restarts, device=device)
    if meas is not None:
        host = host_topology(meas)
        return TuningContext(
            source="measured" if meas.transfer_measured else "simulated",
            params=params,
            faa_cost=meas.local_clocks(),
            faa_same_group=meas.transfer_clocks(),
            faa_remote_cost=host.r_cross_group - host.r_same_core,
            per_item_cost=meas.dispatch_clocks(),
            dispatch_overhead_s=meas.dispatch_ns * 1e-9,
            host_cores=meas.cores,
            host_groups=host.n_groups,
            fit_loss=loss,
            n_points=len(y),
        )
    ref = W3225R
    return TuningContext(
        source="simulated",
        params=params,
        faa_cost=_REF_LOCAL_CLOCKS,
        faa_same_group=ref.r_same_group + ref.e_faa + ref.o_misc,
        faa_remote_cost=ref.r_cross_group - ref.r_same_core,
        per_item_cost=UnitTask().clocks(),
        dispatch_overhead_s=25e-6,
        host_cores=os.cpu_count() or 1,
        host_groups=1,
        fit_loss=loss,
        n_points=len(y),
    )


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

# the calibration file and the kernel tuning db share the versioned-artifact
# envelope (repro_torch.core.runtime.artifacts): a reader only trusts an exact
# (kind, version) match and falls back to the analytic default otherwise.
CALIBRATION_KIND = "calibration"
CALIBRATION_VERSION = 1


def save_calibration(ctx: TuningContext, path: os.PathLike | str) -> Path:
    return save_artifact(path, kind=CALIBRATION_KIND,
                         version=CALIBRATION_VERSION,
                         payload=ctx.as_json_dict())


def load_calibration(path: os.PathLike | str) -> Optional[TuningContext]:
    payload = load_artifact(path, kind=CALIBRATION_KIND,
                            version=CALIBRATION_VERSION)
    if payload is None:
        # pre-envelope calibrations were the bare payload dict
        p = Path(path)
        if not p.exists():
            return None
        try:
            payload = json.loads(p.read_text())
        except (ValueError, OSError):
            return None
    try:
        return TuningContext.from_json_dict(payload)
    except (ValueError, KeyError, TypeError):
        return None  # torn/stale file: fall back to the default context


# ---------------------------------------------------------------------------
# Validation: does the fitted model agree with the event model?
# ---------------------------------------------------------------------------

def _rank(values: np.ndarray) -> np.ndarray:
    order = np.argsort(values, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(values))
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    ra, rb = _rank(np.asarray(a, float)), _rank(np.asarray(b, float))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def ranking_consistency(
    ctx: TuningContext,
    topo: CpuTopology,
    n_threads: int,
    task: UnitTask,
    *,
    n: int = 512,
    blocks: Optional[Sequence[int]] = None,
) -> dict:
    """Compare block-size rankings: event-model latency vs the calibrated
    analytic cost, plus where the fitted rational model's suggestion lands
    on the simulated curve.  One row per (topology, threads, task) cell.
    """
    blocks = list(blocks) if blocks is not None else [2 ** i for i in range(9)]
    sim = atomic_sim.sweep_block_sizes(topo, n_threads, task, n=n,
                                       block_sizes=blocks, seeds=1)
    groups = topo.groups_used(n_threads)
    analytic = [
        cm.analytic_cost(
            n, b, topo.r_same_group + topo.e_faa + topo.o_misc,
            task.clocks(), n_threads, quota=topo.quota_jitter,
            groups=groups,
            faa_remote_cost=topo.r_cross_group - topo.r_same_core)
        for b in blocks
    ]
    feats = cm.WorkloadFeatures(
        core_groups=groups, threads=n_threads, unit_read=task.unit_read,
        unit_write=task.unit_write, unit_comp=task.unit_comp)
    model_b = ctx.suggest_block(feats, n=n)
    nearest = min(blocks, key=lambda b: abs(b - model_b))
    sim_latencies = [sim[b] for b in blocks]
    sim_best = min(sim, key=sim.get)
    return {
        "topology": topo.name,
        "threads": n_threads,
        "unit_read": task.unit_read,
        "unit_write": task.unit_write,
        "unit_comp": task.unit_comp,
        "spearman_sim_vs_analytic": spearman(sim_latencies, analytic),
        "sim_best_block": int(sim_best),
        "model_block": int(model_b),
        "sim_at_model_block": float(sim[nearest]),
        "sim_at_best_block": float(sim[sim_best]),
        "sim_at_block_1": float(sim[1]),
        "model_within_nt": bool(model_b < max(1.0, n / n_threads)),
    }
