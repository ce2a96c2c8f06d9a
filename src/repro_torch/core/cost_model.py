"""The paper's cost model, forward half, in numpy.

Analytic model (paper, Problem statement)::

    Cost(T, N, L) = N/B * L + O(N)/T

Learned model (paper, Cost model and improvements)::

    B = (alpha*G + delta0) / (beta0*T + beta1*R + beta2*W + beta3*C + delta1)

with the published trained weights (on normalized inputs)::

    B = (1558.31 - 61.84*G) / (693.13 - 10.48*T - 33.71*R - 34.50*W - 26.84*C)

Normalization (paper): G is multiplied by 100; unit read/write are replaced by
``n`` such that ``2^n = unit``; unit computation by ``p`` such that
``unit = 2^(10p)`` (i.e. log base 1024).

Prediction runs in float32, as the reference does.  The speculation
half (``expected_accept_span``, ``speculative_token_cost``,
``best_draft_span``: the draft span read as the block size) is here too.
Training the model (``init_params`` / ``loss_fn`` /
``train_cost_model``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np


# --------------------------------------------------------------------------
# Features & normalization
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadFeatures:
    """Raw (un-normalized) inputs of the cost model."""

    core_groups: int
    threads: int
    unit_read: int
    unit_write: int
    unit_comp: int

    def normalized(self) -> np.ndarray:
        """Paper's normalization -> [G*100, T, log2 R, log2 W, log1024 C]."""
        return np.array(
            [
                100.0 * self.core_groups,
                float(self.threads),
                np.log2(max(2.0, float(self.unit_read))),
                np.log2(max(2.0, float(self.unit_write))),
                np.log2(max(2.0, float(self.unit_comp))) / 10.0,
            ],
            dtype=np.float32,
        )

    def normalized_ext(self, faa_latency: float,
                       bw_bytes_per_clock: float) -> np.ndarray:
        """The paper's future-work features appended: cross-group FAA
        latency (log2 clocks) and platform DRAM bandwidth (log2 B/clk)."""
        return np.concatenate([
            self.normalized(),
            np.array([np.log2(max(2.0, faa_latency)),
                      np.log2(max(2.0, bw_bytes_per_clock))], np.float32),
        ])


def normalize_batch(feats: Iterable[WorkloadFeatures]) -> np.ndarray:
    return np.stack([f.normalized() for f in feats])


# --------------------------------------------------------------------------
# Rational model  B = (a*G + d0) / (b . [T,R,W,C] + d1)
# --------------------------------------------------------------------------

# Published trained weights (paper, end of "Cost model and improvements").
PAPER_WEIGHTS = {
    "alpha": np.array([-61.84], np.float32),
    "delta0": np.array([1558.31], np.float32),
    "beta": np.array([-10.48, -33.71, -34.50, -26.84], np.float32),
    "delta1": np.array([693.13], np.float32),
}


def predict(params: dict, x: np.ndarray) -> np.ndarray:
    """x: [batch, 5] normalized features -> predicted block size [batch]."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    x = np.asarray(x, np.float32)
    power = p["alpha"][0] * x[:, 0] + p["delta0"][0]
    cost = x[:, 1:] @ p["beta"] + p["delta1"][0]
    return power / cost


# --------------------------------------------------------------------------
# Analytic model & block-size suggestion API
# --------------------------------------------------------------------------

def analytic_cost(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, quota: float = 0.0, *, groups: int = 1,
    faa_remote_cost: float = 0.0,
) -> float:
    """Paper's Cost(T,N,L) = N/B * L + O(N)/T, plus the imbalance term the
    paper observes empirically (quota-jitter tail ~ one block per thread).

    ``groups``/``faa_remote_cost`` extend L with the cross-core-group line
    transfer (Schweizer et al.): with T threads spread over G groups, a
    claim on the flat shared counter finds the line in a foreign group with
    probability (G-1)/G and pays ``faa_remote_cost`` extra clocks on top of
    the local ``faa_cost``.  Defaults (G=1, remote=0) reproduce the paper's
    published single-term model exactly."""
    b = max(1.0, float(block_size))
    p_remote = (groups - 1.0) / groups if groups > 1 else 0.0
    sync = (n / b) * (faa_cost + p_remote * faa_remote_cost)
    work = n * per_item_cost / threads
    imbalance = quota * b * per_item_cost  # tail: last block finishes late
    return sync + work + imbalance


def analytic_hierarchical_cost(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, quota: float = 0.0, *, groups: int = 1,
    faa_remote_cost: float = 0.0, fanout: int = 8,
) -> float:
    """Cost of the two-level ``hierarchical`` policy under the same model.

    Every claim still pays a (group-local) ``faa_cost``, but only one in
    ``fanout`` touches the shared counter and risks the cross-group
    transfer; the price is a coarser shared granularity, so the jitter tail
    scales with the super-block (``fanout * B``) instead of B.  Comparing
    this against :func:`analytic_cost` at equal B is how the model ranks
    ``hierarchical`` vs flat ``faa`` (see :func:`rank_schedules`)."""
    b = max(1.0, float(block_size))
    p_remote = (groups - 1.0) / groups if groups > 1 else 0.0
    local = (n / b) * faa_cost
    shared = (n / (b * fanout)) * p_remote * faa_remote_cost
    work = n * per_item_cost / threads
    imbalance = quota * b * fanout * per_item_cost
    return local + shared + work + imbalance


def rank_schedules(
    n: int, block_size: float, faa_cost: float, per_item_cost: float,
    threads: int, *, groups: int = 1, faa_remote_cost: float = 0.0,
    quota: float = 0.35, fanout: int = 8,
) -> list:
    """[(policy, predicted_clocks)] sorted cheapest-first for the flat-FAA
    family the analytic model covers: ``faa``, ``hierarchical``, ``static``.

    ``static`` pays no sync but eats the full quota-jitter tail of its
    N/T-sized ranges; ``faa`` pays a (possibly remote) FAA per block;
    ``hierarchical`` trades shared-line traffic for a coarser tail.  On
    multi-group topologies with expensive remote transfers the ranking
    flips toward ``hierarchical`` — the paper's motivating regime."""
    costs = {
        "faa": analytic_cost(
            n, block_size, faa_cost, per_item_cost, threads, quota,
            groups=groups, faa_remote_cost=faa_remote_cost),
        "hierarchical": analytic_hierarchical_cost(
            n, block_size, faa_cost, per_item_cost, threads, quota,
            groups=groups, faa_remote_cost=faa_remote_cost, fanout=fanout),
        "static": analytic_cost(
            n, max(1.0, n / max(1, threads)), 0.0, per_item_cost, threads,
            quota),
    }
    return sorted(costs.items(), key=lambda kv: kv[1])


def analytic_best_block(
    n: int, faa_cost: float, per_item_cost: float, threads: int,
    quota: float = 0.35,
) -> int:
    """argmin_B of analytic_cost — closed form sqrt(N*L/(quota*c))."""
    b = np.sqrt(n * faa_cost / max(quota * per_item_cost, 1e-12))
    return int(np.clip(b, 1, max(1, n // max(1, threads))))


# --------------------------------------------------------------- speculation
# Speculative decoding is the serving-side instance of the paper's grain
# trade: one verification amortizes the per-token claim/admission
# bookkeeping (the FAA term) over a whole accepted span, and the draft
# span k is the block size B.  With per-draft-token acceptance
# probability a and longest-matching-prefix greedy acceptance, the span
# emitted per verify is 1 + (number of leading matches), so
# E[tokens/verify] = sum_{j=0..k} a^j.


def expected_accept_span(k: int, acceptance: float) -> float:
    """E[tokens emitted per verify] at draft span ``k``: geometric
    longest-prefix acceptance, sum_{j=0..k} a^j = (1-a^(k+1))/(1-a)."""
    if k < 0:
        raise ValueError(f"draft span must be >= 0, got {k}")
    a = min(max(float(acceptance), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculative_token_cost(
    k: int, acceptance: float, *, draft_cost: float, verify_cost: float,
    sync_cost: float = 0.0,
) -> float:
    """Expected cost per *emitted* token at draft span ``k``: ``k``
    drafter steps, one verify and the per-tick host bookkeeping
    (``sync_cost``: acceptance scan, length rollback — the FAA analogue)
    over ``expected_accept_span(k, a)`` tokens.  ``k = 0`` is the
    non-speculative baseline."""
    e = expected_accept_span(k, acceptance)
    return (k * draft_cost + verify_cost + sync_cost) / e


def best_draft_span(
    acceptance: float, *, draft_cost: float, verify_cost: float,
    sync_cost: float = 0.0, max_k: int = 8,
) -> int:
    """argmin_k of :func:`speculative_token_cost` over 0..max_k — the
    grain-size choice, mirroring :func:`analytic_best_block`."""
    costs = [speculative_token_cost(k, acceptance, draft_cost=draft_cost,
                                    verify_cost=verify_cost,
                                    sync_cost=sync_cost)
             for k in range(max_k + 1)]
    return int(np.argmin(costs))


_DEFAULT_PARAMS: Optional[dict] = None


def default_params() -> dict:
    """Paper's published weights (the faithful default; retrained weights can
    be installed via set_default_params)."""
    global _DEFAULT_PARAMS
    return _DEFAULT_PARAMS if _DEFAULT_PARAMS is not None else PAPER_WEIGHTS


def set_default_params(params: dict) -> None:
    global _DEFAULT_PARAMS
    _DEFAULT_PARAMS = params


def suggest_block_size(
    feats: WorkloadFeatures, *, n: Optional[int] = None,
    params: Optional[dict] = None,
) -> int:
    """Predict the block size for a workload; clamps to [1, n]."""
    p = params or default_params()
    b = float(predict(p, feats.normalized()[None, :])[0])
    if not np.isfinite(b) or b < 1:
        b = 1
    if n is not None:
        b = min(b, n)
        # the paper's own empirical bound: B* sits below N/T — never let the
        # regressor starve parallelism
        b = min(b, max(1.0, n / (2 * max(feats.threads, 1))))
    return max(1, int(round(b)))
