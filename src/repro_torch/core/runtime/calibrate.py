"""The tuning context every granularity knob consults.

Only the un-calibrated default is ported: the paper's published weights
plus the reference platform's FAA constants.  Host measurement, fitting
and persisted calibration are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.atomic_sim import UnitTask
from repro_torch.core.topology import W3225R

__all__ = ["TuningContext", "default_context"]

# Local FAA latency of the reference platform in simulator clocks.
_REF_LOCAL_CLOCKS = W3225R.r_same_core + W3225R.e_faa + W3225R.o_misc


@dataclasses.dataclass
class TuningContext:
    """Platform granularity advisor.

    ``params`` are the rational model's coefficients (the paper's
    published weights for the ``default`` context).  The FAA terms are in
    simulator clocks.
    """

    source: str                   # "default"
    params: dict
    faa_cost: float               # local FAA, clocks
    faa_remote_cost: float        # EXTRA clocks for a cross-group claim
    per_item_cost: float          # reference per-item dispatch, clocks
    host_groups: int
    # per-chunk dispatch overhead L in seconds: the measured search's
    # prior (core/autotune_search); the reference's un-calibrated default
    dispatch_overhead_s: float = 25e-6

    def suggest_block(self, feats: cm.WorkloadFeatures,
                      n: Optional[int] = None) -> int:
        """The learned model's block size under THIS context's weights."""
        return cm.suggest_block_size(feats, n=n, params=self.params)

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
        at this context's per-item cost); the per-tick host bookkeeping
        is priced at the FAA costs (remote share weighted by the group
        count, as in ``analytic_cost``)."""
        verify = max(1e-9, self.per_item_cost)
        groups = max(1, self.host_groups)
        sync = self.faa_cost + self.faa_remote_cost * (groups - 1) / groups
        return cm.best_draft_span(
            acceptance, draft_cost=draft_cost_ratio * verify,
            verify_cost=verify + sync, max_k=max_k)


def default_context() -> TuningContext:
    """The un-calibrated context: published weights + reference-platform
    constants.  Every consumer works; nothing is measured."""
    ref = W3225R
    return TuningContext(
        source="default",
        params={k: np.asarray(v) for k, v in cm.PAPER_WEIGHTS.items()},
        faa_cost=_REF_LOCAL_CLOCKS,
        faa_remote_cost=ref.r_cross_group - ref.r_same_core,
        per_item_cost=UnitTask().clocks(),
        host_groups=1,
        dispatch_overhead_s=25e-6,
    )
