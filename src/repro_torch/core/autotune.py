"""Granularity choices: the host's from the cost model, and the SSD chunk.

Port of ``repro.core.autotune``, reduced to :func:`data_grain_size` and
:data:`SSD_CHUNK`.  The data pipeline's host stage is a multicore CPU, so
the paper's learned model applies to it as written.  The reference's
default topology there is one TPU pod (``n_pods = 1``), so its feature
vector has one core group;
the port states ``core_groups=1`` directly and carries no TPU constant.
The device-side choices (attention blocks, decode splits, microbatch
count) rest on TPU priors and wait for the measured autotuner for Hopper
(ROADMAP: the pipelined kernels and the measured autotuner).

The SSD chunk is the reference's ``ssd_chunk_size`` on Hopper's terms.
The reference ranks chunks against a TPU VMEM budget and MXU edge; here
the chunk is what one block of K12 (``csrc/mamba_ssd.cu``) holds in shared
memory: a chunk's B and C tiles ([64, N] f32 each, 66 KB at N = 128), its
[64, 64] decay-weighted score tile (16.6 KB), its x tile and the block's
state slice, about 100 KB at N = 128, so two blocks share an SM's 227 KB.
A longer chunk would halve that occupancy and grow the quadratic in-chunk
work; a shorter one lengthens the sequential state handoff.  Any sequence
length works: the last chunk is ragged.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import cost_model as cm

SSD_CHUNK = 64      # rows of one SSD chunk (see the module docstring)


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
