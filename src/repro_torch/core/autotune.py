"""Granularity choices: the paper's cost model applied to the card's knobs
and the host's.

Port of ``repro.core.autotune``.  Every device knob below is an instance
of the paper's block-size problem: work is split into chunks, each chunk
carries a fixed scheduling / synchronization overhead (the FAA-cost
analogue ``L``), and oversized chunks lose parallelism or overflow the
fast memory.  The rankings are the reference's, rewritten on the H100's
terms: the budget is the 227 KB of shared memory a block may opt into
(not the TPU's VMEM), bytes move at 3.35 TB/s, the products are costed at
989 TFLOP/s (bf16; 67 for the f32 flash kernels on the CUDA cores), each
shared out over the card's SMs, a decode split is a block of its own (the
splits run in parallel, not one after another), and ``L`` is the tuning
context's dispatch overhead (the reference's un-calibrated default, 25
us, or a calibrated host's, floored at 1 us as the reference floors it),
paid once per launch.  No TPU constant (lane count, MXU edge, VMEM,
pod topology) enters.

Knobs governed here:

* the attention kernels' KV staging-ring depth ``num_buffers`` (K1/K4,
  K2/K5, K3/K6, K8/K9) and the decode split count (K2/K5, K7): ranked
  candidates for the measured search (``core/autotune_search``).  The
  port's tiles are compiled constants (16 query x 32 KV rows on the CUDA
  cores; 64 x 64 for the bf16 flash forward and 16 query heads x 64 KV
  rows, 32 at MLA's 576 / 512, for the bf16-query decode on the tensor
  cores, over a bf16 or a 1-byte cache),
  so the reference's ``(block_q, block_k)`` have no counterpart yet;
* data-pipeline ``grain``: host-side, the learned model directly with the
  paper's feature semantics (:func:`data_grain_size`);
* a host block size by the analytic cost (:func:`choose_block`), under
  the tuning context's calibrated terms unless the caller gives its own;
* the SSD chunk (:data:`SSD_CHUNK`), a compiled constant of K12.

The reference's ``ssd_chunk_candidates``, ``gmm_tile_candidates`` and
``microbatch_count`` are not ported (ROADMAP: the measured autotuner's
remaining specs, and its training half).

The SSD chunk is the reference's ``ssd_chunk_size`` on Hopper's terms.
The reference ranks chunks against a TPU VMEM budget and MXU edge; here
the chunk is what one block of K12 (``csrc/mamba_ssd.cu``) stages per
step of its sequential loop.  In bf16 (the serve path: the tensor-core
kernel, ``kernels/mamba_ssd/ops.py``) a block takes 32 of a head's P
columns and holds two ring stages of the chunk's raw bf16 C and B tiles
([64, N] each, rows padded by 16 bytes), x tile and dt, its slice of the
state twice in bf16 (the entering one and the leaving one) and each
warp's cumulative decay: 96.5 KB at P = 64, N = 128 (``SsdMmaSmem``), so
2 blocks an SM; the f32 state itself lives in registers.  The chunk's 64
rows are 4 warps of 16, the m16 rows of the tensor cores' products.  A
longer chunk would grow the quadratic in-chunk work and the stages; a
shorter one lengthens the sequential state handoff.  Any sequence length works: the last chunk is ragged.  (f32,
the CUDA-core kernel, stages f32 tiles: about 100 KB at N = 128.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model as cm

SSD_CHUNK = 64      # rows of one SSD chunk (see the module docstring)

# NVIDIA H100 SXM (data sheet): dynamic shared memory a block may opt
# into, HBM3 bandwidth, dense bf16 tensor-core rate, streaming
# multiprocessors
SMEM_BUDGET = 232_448
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
H100_SMS = 132

BLOCK_Q = 16        # query rows of an f32 K1 / K4 block (flash_attention.cu)
BLOCK_K = 32        # KV rows of a tile in every CUDA-core attention kernel
MMA_BLOCK_Q = 64    # query rows of a bf16 K1 / K4 block (the tensor cores)
MMA_BLOCK_K = 64    # KV rows of its tiles
DECODE_HEADS = 16   # query heads of a decode block: the rows of its tile
F32_FLOPS = 67e12   # f32 rate outside the tensor cores (the f32 kernels')
MIN_SPLIT_ROWS = 64  # fewest cache rows one decode split may hold


def decode_mma_block_k(dk: int, dv: int) -> int:
    """KV rows of a tile of the bf16 decode kernel on the tensor cores
    (``DecodeMmaSmem::kBK`` in csrc/decode_attention.cu): 64, or 32 where
    a 64-row stage would leave no room for a ring (MLA's 576 / 512)."""
    return 64 if dk + dv <= 256 else 32


def sm_count() -> int:
    """The current card's SM count; the H100's where there is no card
    (the CPU, whose plain versions use no split plan)."""
    if torch.cuda.is_available():
        return _sm_count(torch.cuda.current_device())
    return H100_SMS


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def fit_block(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (always >= 1).

    The replacement for the old ``while n % b: b //= 2`` halving loop,
    which collapses far below the tuned block for non-power-of-two
    extents (e.g. n=96 with a tuned 128 halves down to 32 and n=100 all
    the way to 4, skipping the perfectly feasible 96 and 25).  Picking
    the largest feasible *divisor* keeps the realized block as close to
    the tuned choice as the grid constraint allows.
    """
    n = max(1, int(n))
    t = max(1, min(int(target), n))
    best = 1
    i = 1
    while i * i <= n:
        if n % i == 0:
            if i <= t:
                best = max(best, i)
            j = n // i
            if j <= t:
                best = max(best, j)
        i += 1
    return best


def choose_block(
    n: int,
    workers: int,
    overhead: Optional[float] = None,
    per_item_cost: Optional[float] = None,
    *,
    candidates: Optional[Sequence[int]] = None,
    jitter: float = 0.35,
) -> int:
    """argmin over candidates of the paper's analytic cost.

    With ``overhead=None`` AND ``per_item_cost=None`` the choice is
    delegated to the calibrated :class:`repro_torch.core.runtime.TuningContext`
    — measured L, cross-group penalty and all — so there is one
    implementation and one answer.  Passing exactly one of the two is an
    error: the context's terms are in simulator clocks and must not be
    mixed with a caller's own unit system (e.g. seconds)."""
    if (overhead is None) != (per_item_cost is None):
        raise ValueError(
            "pass both overhead and per_item_cost (one unit system), or "
            "neither (the calibrated TuningContext supplies both)")
    if overhead is None:
        from repro_torch.core import runtime  # lazy: runtime consults cost_model

        return runtime.tuning().choose_block(
            n, workers, candidates=candidates, jitter=jitter)
    cands = list(candidates) if candidates is not None else [
        2**i for i in range(int(np.log2(max(2, n))) + 1)
    ]
    cands = [c for c in cands if 1 <= c <= n] or [1]
    costs = [
        cm.analytic_cost(n, c, overhead, per_item_cost, workers, quota=jitter)
        for c in cands
    ]
    return int(cands[int(np.argmin(costs))])


def fit_buffer_depth(
    depth: int,
    block_bytes: int,
    *,
    smem_limit: Optional[int] = None,
    base_bytes: int = 0,
) -> int:
    """Largest staging-ring depth <= ``depth`` whose resident bytes
    (``base_bytes + depth * block_bytes``) fit the shared-memory budget —
    the single-buffer fallback of the pipelined kernels: depth halves
    until it fits, bottoming out at 1 (the classic, non-pipelined
    kernel)."""
    limit = SMEM_BUDGET if smem_limit is None else int(smem_limit)
    d = max(1, int(depth))
    while d > 1 and base_bytes + d * block_bytes > limit:
        d //= 2
    return d


def _overhead() -> float:
    """The per-launch overhead L of the kernel priors: the tuning context's
    dispatch overhead, floored at 1 us as the reference floors it (a
    calibrated host measures a Python dispatch, well under a launch)."""
    from repro_torch.core import runtime  # lazy: runtime consults cost_model

    return max(1e-6, runtime.tuning().dispatch_overhead_s)


def _tile_s(depth: int, load_s: float, compute_s: float) -> float:
    """One KV tile of a block: without a ring (depth 1) the block waits
    for the tile's bytes, then computes on them; a ring (depth >= 2) keeps
    the next tiles' loads in flight under this one's products."""
    return load_s + compute_s if depth == 1 else max(load_s, compute_s)


@dataclasses.dataclass(frozen=True)
class AttentionBlocks:
    block_q: int
    block_k: int
    smem_bytes: int
    num_buffers: int = 1


def attention_block_candidates(
    seq_q: int,
    seq_k: int,
    head_dim: int,
    *,
    dv: int,
    dtype_bytes: int,
    base_bytes: int,
    stage_bytes: int,
    buffer_depths: Sequence[int],
) -> list[AttentionBlocks]:
    """Feasible K1 / K4 configurations ranked by the analytic cost, best
    first — the prior-generation layer for the measured search.

    The tiles and the rate are those of the path the dtype launches: bf16
    (``dtype_bytes`` 2) runs on the tensor cores in ``MMA_BLOCK_Q`` x
    ``MMA_BLOCK_K`` tiles at the bf16 rate, f32 on the CUDA cores in
    ``BLOCK_Q`` x ``BLOCK_K`` tiles at the f32 rate.  The candidates are
    the ring depths whose shared memory (``base_bytes + depth *
    stage_bytes``, the kernel's real layout) fits the budget.  One call
    is one launch and pays the overhead L once.  A (batch row, query head)
    walks (Sq / bq) * (Skv / bk) tiles, each loading its K/V rows at one
    SM's share of the HBM rate and computing its products at one SM's
    share of the path's rate; depth 1 (K1) pays the two in turn, a ring
    (K4) the larger (:func:`_tile_s`)."""
    sms = sm_count()
    if dtype_bytes == 2:
        bq, bk, flops = MMA_BLOCK_Q, MMA_BLOCK_K, PEAK_FLOPS
    else:
        bq, bk, flops = BLOCK_Q, BLOCK_K, F32_FLOPS
    steps = max(1, -(-seq_q // bq)) * max(1, -(-seq_k // bk))
    load_s = dtype_bytes * bk * (head_dim + dv) * sms / HBM_BYTES_PER_S
    compute_s = 2.0 * bq * bk * (head_dim + dv) * sms / flops
    scored = []
    for depth in sorted(set(max(1, int(nb)) for nb in buffer_depths)):
        smem = base_bytes + depth * stage_bytes
        if depth > 1 and smem > SMEM_BUDGET:
            continue
        cost = _overhead() + steps * _tile_s(depth, load_s, compute_s)
        scored.append((cost, AttentionBlocks(bq, bk, smem, depth)))
    scored.sort(key=lambda s: s[0])
    return [blocks for _, blocks in scored]


def decode_split_buffer_candidates(
    seq_len: int,
    *,
    rows: int,
    head_dim: int,
    dv: int,
    dtype_bytes: int,
    base_bytes: int,
    stage_bytes: int,
    buffer_depths: Sequence[int],
) -> list[tuple[int, int]]:
    """(num_splits, num_buffers) pairs ranked by the analytic cost, best
    first — the joint prior for the split-K decode search (K2 / K5, and
    K7 with ``buffer_depths=(1,)``).

    The split counts are the powers of two and :func:`decode_split_k`'s,
    none shorter than ``MIN_SPLIT_ROWS`` rows.  A call is one launch of
    ``rows * s`` split blocks and the combine: L once.  Each block streams
    its ``seq_len / s`` rows of ``(head_dim + dv) * dtype_bytes`` bytes at
    one SM's share of the HBM rate, less when the blocks outnumber the
    SMs, so splits gain until the blocks cover every SM; the f32 partials
    each split writes and the combine reads are costed at the HBM rate.
    The tiles and the rate are those of the path the dtype launches: a
    bf16 cache (``dtype_bytes`` 2) and a 1-byte one (1: K7 / K8 / K9,
    whose served queries are bf16) run on the tensor cores, a tile of
    ``DECODE_HEADS`` query rows (the m16 operand, whatever the group) by
    :func:`decode_mma_block_k` KV rows at the bf16 rate; f32 on the CUDA
    cores, one query head's ``BLOCK_K``-row tile (the warps score their
    heads side by side) at the f32 rate.  A tile
    costs its load and its products in turn at depth 1, the larger of them
    under a ring (:func:`_tile_s`; K5 keeps K2's split-parallel grid).  A
    depth is feasible when its ring fits the budget (``base_bytes + D *
    stage_bytes``)."""
    sms = sm_count()
    if dtype_bytes in (1, 2):
        bq, bk, flops = DECODE_HEADS, decode_mma_block_k(head_dim, dv), \
            PEAK_FLOPS
    else:
        bq, bk, flops = 1, BLOCK_K, F32_FLOPS
    row_bytes = (head_dim + dv) * dtype_bytes
    cap = max(1, seq_len // MIN_SPLIT_ROWS)  # always admits 1
    splits = {1, 2, 4, 8, 16, 32, 64, decode_split_k(seq_len, rows=rows)}
    scored = []
    for s in sorted(n for n in splits if n <= cap):
        blocks = rows * s
        split_rows = -(-seq_len // s)
        tiles = -(-split_rows // bk)
        load_s = (split_rows * row_bytes * max(blocks, sms)
                  / HBM_BYTES_PER_S / tiles)
        compute_s = 2.0 * bq * bk * (head_dim + dv) * sms / flops
        partials_s = 2 * 4 * blocks * (dv + 2) / HBM_BYTES_PER_S
        for depth in sorted(set(max(1, int(nb)) for nb in buffer_depths)):
            if depth > 1 and base_bytes + depth * stage_bytes > SMEM_BUDGET:
                continue
            cost = (_overhead() + partials_s
                    + tiles * _tile_s(depth, load_s, compute_s))
            scored.append((cost, (s, depth)))
    scored.sort(key=lambda x: x[0])
    return [pair for _, pair in scored]


def decode_split_k(seq_len: int, *, rows: int,
                   sms: Optional[int] = None) -> int:
    """The analytic pick: enough splits per (row, KV head) for the
    ``rows`` pairs to cover every SM, none shorter than
    ``MIN_SPLIT_ROWS`` cache rows.  This is the split count K2, K3, K7 and
    K8 have always run."""
    sms = sm_count() if sms is None else sms
    want = -(-sms // max(1, rows))
    return max(1, min(want, seq_len // MIN_SPLIT_ROWS))


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
    weights).  The reference's default topology is one TPU pod
    (``n_pods = 1``), so its feature vector has one core group; the port
    states ``core_groups=1`` directly and carries no TPU constant."""
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
