"""Granularity choices from the cost model — only the host's part so far.

Port of ``repro.core.autotune``, reduced to :func:`data_grain_size`: the
data pipeline's host stage is a multicore CPU, so the paper's learned
model applies to it as written.  The reference's default topology there
is one TPU pod (``n_pods = 1``), so its feature vector has one core group;
the port states ``core_groups=1`` directly and carries no TPU constant.
The device-side choices (attention blocks, decode splits, microbatch
count) rest on TPU priors and wait for the measured autotuner for Hopper
(ROADMAP: the pipelined kernels and the measured autotuner).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import cost_model as cm


def data_grain_size(
    n_examples: int,
    *,
    host_threads: int = 8,
    bytes_per_example: int = 4 * 4096,
    core_groups: int = 1,
    params: Optional[dict] = None,
) -> int:
    """Host data-pipeline grain — direct use of the learned model with the
    paper's own feature semantics.

    With ``params=None`` the weights come from the process
    :class:`repro_torch.core.runtime.TuningContext` (the published
    weights)."""
    if params is None:
        from repro_torch.core import runtime  # lazy: runtime consults cost_model

        params = runtime.tuning().params
    feats = cm.WorkloadFeatures(
        core_groups=max(1, core_groups),
        threads=host_threads,
        unit_read=bytes_per_example,
        unit_write=bytes_per_example,
        unit_comp=1024,
    )
    return cm.suggest_block_size(feats, n=n_examples, params=params)
