"""The paper's contribution: FAA claiming at the cost-model's block size."""

from __future__ import annotations

from typing import Optional

from repro_torch.core import cost_model as _cm
from repro_torch.core.schedulers.base import register_scheduler
from repro_torch.core.schedulers.faa import FaaScheduler


@register_scheduler
class CostModelScheduler(FaaScheduler):
    """`faa` with B predicted by the trained rational model.

    The prediction routes through the process
    :class:`repro_torch.core.runtime.TuningContext` — so when an online
    calibration has run (``repro_torch.core.runtime.calibrate``), B comes from
    coefficients refit on *this* platform's measured FAA latencies; with
    no calibration the context falls back to the paper's published
    weights.

    ``cost_inputs`` (a :class:`repro_torch.core.cost_model.WorkloadFeatures`)
    describes the workload; when absent, a neutral single-group profile is
    assumed — the model then mostly reacts to the thread count.
    """

    name = "cost_model"

    def _block_size(self, n: int, t: int, block_size: Optional[int],
                    cost_inputs) -> int:
        if block_size is not None:
            return block_size
        from repro_torch.core import runtime  # lazy: runtime imports schedulers

        feats = cost_inputs or _cm.WorkloadFeatures(
            core_groups=1, threads=t, unit_read=1024, unit_write=1024,
            unit_comp=1024,
        )
        return runtime.tuning().suggest_block(feats, n=n)

    def device_block_size(self, n, workers, block_size=None,
                          cost_inputs=None):
        # explicit B wins, as on the host; else ask the (calibrated) model
        return self._block_size(n, workers, block_size, cost_inputs)
