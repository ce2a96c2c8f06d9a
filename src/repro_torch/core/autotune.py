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

Knobs governed here, each a template choice of its CUDA kernel that the
measured search (``core/autotune_search``) picks among the instances the
library builds, with today's compiled constant or shape rule as the
analytic pick (what a db miss and ``REPRO_TUNING=off`` run):

* the attention kernels' KV staging-ring depth ``num_buffers`` (K1/K4,
  K2/K5, K3/K6, K8/K9) and the decode split count (K2/K5, K7);
* the bf16 flash forward's tile ``(block_q, block_k)`` (K1/K4,
  :func:`attention_block_candidates`): 64 x 64 (``MMA_BLOCK_Q`` x
  ``MMA_BLOCK_K``) at every (Dk, Dv), and at (128, 128) also 16 or 128
  query rows (warps of 16) by 32 or 64 KV rows.  The f32 forward (16 x 32
  on the CUDA cores) has one tile and no ring; the decode kernels keep
  their tiles (16 query heads by 64 KV rows, 32 at MLA's 576 / 512);
* the SSD chunk (K12/K13, :func:`ssd_chunk_candidates`), the reference's
  ``ssd_chunk_size`` on Hopper's terms: the rows one block of K12
  (``csrc/mamba_ssd.cu``) stages per step of its sequential loop, Q / 16
  warps of the tensor cores' m16 rows.  A block takes 32 of a head's P
  columns and holds two ring stages of the chunk's raw bf16 C and B tiles
  ([Q, N] each, rows padded by 16 bytes), x tile and dt, its slice of the
  state twice in bf16 and each warp's cumulative decay: 96.5 KB at Q =
  64, P = 64, N = 128 (``SsdMmaSmem``), so 2 blocks an SM, 56.5 KB at 32,
  178 KB at 128; the f32 state lives in registers.  A longer chunk halves
  the sequential state handoffs, a shorter one the quadratic in-chunk
  work.  Any sequence length works: the last chunk is ragged.  The
  analytic pick is :data:`SSD_CHUNK`; f32 (the CUDA-core kernel) and the
  scan's backward (K16, training) run it only;
* the grouped matmul's tile (K14/K15, :class:`GmmTiles`,
  :func:`gmm_tile_candidates`) in the reference's names: ``block_c`` the
  rows of a tile, ``block_f`` its columns, ``block_d`` the contraction
  depth of a stage, and ``stages``, a key the reference lacks (its
  Pallas pipeline has no ring to size), the ring's stage count.  bf16 K14
  at C > 32 (``wgmma``) chooses the tile height and the stage count, K14
  and K15 at C <= 32 (the weight stream) the tile width; K15 at C > 32
  and the CUDA-core kernels have one tile each;
* data-pipeline ``grain``: host-side, the learned model directly with the
  paper's feature semantics (:func:`data_grain_size`);
* a host block size by the analytic cost (:func:`choose_block`), under
  the tuning context's calibrated terms unless the caller gives its own.

The training half: :func:`microbatch_count`, the reference's gradient
accumulation count, over the cards the batch's rows split across
(``core/topology.py`` ``h100_topology``: the H100's NVLink and bf16
rates).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.topology import (H100_HBM_BW, H100_PEAK_FLOPS,
                                       GpuTopology, h100_topology)

SSD_CHUNK = 64      # rows of one SSD chunk (see the module docstring)

# NVIDIA H100 SXM (data sheet): dynamic shared memory a block may opt
# into, HBM3 bandwidth and the dense bf16 tensor-core rate (the card's
# table, ``core/topology.py``), streaming multiprocessors
SMEM_BUDGET = 232_448
HBM_BYTES_PER_S = H100_HBM_BW
PEAK_FLOPS = H100_PEAK_FLOPS["bf16"]
H100_SMS = 132

BLOCK_Q = 16        # query rows of an f32 K1 block (flash_attention.cu)
BLOCK_K = 32        # KV rows of a tile in every CUDA-core attention kernel
MMA_BLOCK_Q = 64    # query rows of a bf16 K1 / K4 block (the tensor cores)
MMA_BLOCK_K = 64    # KV rows of its tiles
DECODE_HEADS = 16   # query heads of a decode block: the rows of its tile
F32_FLOPS = H100_PEAK_FLOPS["f32"]   # outside the tensor cores (f32 kernels)
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
    tiles: Sequence[tuple],
    ring_smem: Callable[[int, int], tuple],
    buffer_depths: Sequence[int],
) -> list[AttentionBlocks]:
    """Feasible bf16 K1 / K4 configurations ranked by the analytic cost,
    best first — the prior-generation layer for the measured search.

    The candidates are the built tiles ``tiles`` ((block_q, block_k)
    pairs of the tensor-core forward) at each ring depth whose shared
    memory fits the budget (``ring_smem(bq, bk)`` gives the kernel's real
    layout, (base, stage): ``base + depth * stage`` bytes).  One call is
    one launch and pays the overhead L once.  A (batch row, query head)
    walks ceil(Sq / bq) * ceil(Skv / bk) tiles, each loading its bf16 K/V
    rows at one SM's share of the HBM rate and computing its products at
    one SM's share of the bf16 rate; depth 1 (K1) pays the two in turn, a
    ring (K4) the larger (:func:`_tile_s`).  Ties keep the order of
    ``tiles`` and the shallower ring first."""
    sms = sm_count()
    scored = []
    for bq, bk in tiles:
        steps = max(1, -(-seq_q // bq)) * max(1, -(-seq_k // bk))
        load_s = 2 * bk * (head_dim + dv) * sms / HBM_BYTES_PER_S
        compute_s = 2.0 * bq * bk * (head_dim + dv) * sms / PEAK_FLOPS
        base, stage = ring_smem(bq, bk)
        for depth in sorted(set(max(1, int(nb)) for nb in buffer_depths)):
            smem = base + depth * stage
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


def ssd_mma_smem(chunk: int, headdim: int, d_state: int, *,
                 x_bytes: int = 2) -> int:
    """Shared memory of one block of the tensor-core scan at this chunk
    (``SsdMmaSmem`` in csrc/mamba_ssd.cu), in bytes: two ring stages of
    the chunk's C and B rows ([Q, N + 8] bf16 each), x rows ([Q, PB + 8]
    bf16, or [Q, PB + 16] bytes for K13's 1-byte x) and dt; two [PB, N + 8]
    bf16 state buffers; each of the Q / 16 warps' cum; for K13 the
    converted bf16 x tile and the chunk's row scales."""
    pb = min(headdim, 32)
    ns, xs = d_state + 8, pb + 8
    x_row = pb + 16 if x_bytes == 1 else 2 * xs
    stage = 2 * 2 * chunk * ns + chunk * x_row + 4 * chunk
    total = 2 * stage + 2 * 2 * pb * ns + 4 * (chunk // 16) * chunk
    if x_bytes == 1:
        total += 2 * chunk * xs + 4 * chunk
    return total


def ssd_chunk_candidates(
    seq_len: int,
    headdim: int = 64,
    d_state: int = 128,
    *,
    dtype_bytes: int = 2,
    heads: int = 1,
    options: Sequence[int] = (SSD_CHUNK,),
) -> list[int]:
    """The built chunks ``options`` of the tensor-core scan (K12 / K13)
    ranked by the analytic cost, best first — the reference's tradeoff
    (quadratic in-chunk work against a per-chunk step of the sequential
    scan) on the card's terms.

    A call is one launch (L once) of ``heads`` x ceil(P / 32) blocks, each
    of Q / 16 warps, as many an SM as their shared memory
    (:func:`ssd_mma_smem`) lets share the 227 KB budget.  A block walks
    ceil(S / Q) chunks in order; each chunk loads its B and C rows (bf16),
    x (``dtype_bytes`` a value) and dt and writes its y rows at the
    block's share of the HBM rate, and computes C B^T and M x (the causal
    halves), C state^T and the state update (two products: the hi / lo
    split) at its share of the bf16 rate: the SM's, times the share of
    the SM's four tensor-core quarters its warps reach (a block of 2 warps
    reaches half), or a fair share where blocks outnumber the SMs.  The
    2-stage ring overlaps a chunk's load with the products of the one
    before (:func:`_tile_s` at depth 2).  Blocks past the resident ones
    run in later waves.  A chunk needs at least 32 rows of sequence to be
    ranked; the classic :data:`SSD_CHUNK` is always kept."""
    sms = sm_count()
    pb = min(headdim, 32)
    blocks = max(1, heads) * -(-headdim // pb)
    scored = []
    for q in sorted(set(int(c) for c in options)):
        if q > max(seq_len, SSD_CHUNK) or q < 32:
            continue
        smem = ssd_mma_smem(q, headdim, d_state, x_bytes=dtype_bytes)
        if smem > SMEM_BUDGET:
            continue
        per_sm = max(1, SMEM_BUDGET // smem)
        live = min(blocks, sms * per_sm)
        waves = -(-blocks // (sms * per_sm))
        if live <= sms:
            rate = PEAK_FLOPS / sms * min(1.0, (q // 16) / 4)
        else:
            rate = PEAK_FLOPS / live
        bw = HBM_BYTES_PER_S / live
        chunk_bytes = q * (2 * 2 * d_state + pb * (dtype_bytes + 2) + 4)
        chunk_flops = 2.0 * (q * q / 2 * (d_state + pb) + q * d_state * pb
                             + 2 * q * pb * d_state)
        chunks = -(-max(1, seq_len) // q)
        cost = _overhead() + waves * chunks * _tile_s(
            2, chunk_bytes / bw, chunk_flops / rate)
        scored.append((cost, q != SSD_CHUNK, q))
    if not scored:
        return [SSD_CHUNK]
    scored.sort()
    return [q for _, _, q in scored]


def ssd_chunk_size(seq_len: int, headdim: int = 64, d_state: int = 128, *,
                   dtype_bytes: int = 2) -> int:
    """The analytic pick: :data:`SSD_CHUNK`, the chunk K12 and K13 ran
    before the chunk was a choice (what a db miss runs)."""
    return SSD_CHUNK


@dataclasses.dataclass(frozen=True)
class GmmTiles:
    """A grouped-matmul tile in the reference's names: ``block_c`` rows
    (capacity rows of x), ``block_f`` output columns, ``block_d`` the
    contraction depth of one stage; ``stages``, a key of the port's own,
    the stages of the kernel's ring (0: the kernel has no ring)."""

    block_c: int
    block_f: int
    block_d: int
    stages: int = 0

    def config(self) -> dict:
        """As a tuning config; ``stages`` only where the kernel has a
        ring."""
        cfg = {"block_c": self.block_c, "block_f": self.block_f,
               "block_d": self.block_d}
        if self.stages:
            cfg["stages"] = self.stages
        return cfg


def gmm_tile_candidates(
    c: int,
    d: int,
    f: int,
    *,
    dtype_bytes: int = 2,
    weight_bytes: int = 2,
    experts: int = 1,
    options: Sequence[GmmTiles],
) -> list[GmmTiles]:
    """The built tiles ``options`` of the kernel a grouped matmul x [E, C,
    d] @ w [E, d, f] runs, ranked by the analytic cost, best first.

    One launch (L once) of ``experts`` x ceil(C / block_c) x ceil(f /
    block_f) tiles; a tile reads d x block_f weights (``weight_bytes``
    each) and its block_c rows of x (``dtype_bytes``), writes block_c x
    block_f outputs and computes 2 block_c block_f d operations.  As many
    tiles run at once as the blocks whose ring (``stages`` x block_d x
    (block_c + block_f) bf16) shares an SM's 227 KB (one, for the
    persistent ``wgmma`` blocks), each at its share of the HBM rate and of
    the SM's bf16 rate, a tile paying the larger (the ring overlaps
    them); tiles past the resident ones run in later waves.  Ties keep
    the order of ``options``."""
    sms = sm_count()
    scored = []
    for i, t in enumerate(options):
        ring = max(1, t.stages) * t.block_d * (t.block_c + t.block_f) * 2
        if ring > SMEM_BUDGET:
            continue
        per_sm = max(1, SMEM_BUDGET // ring) if t.block_c <= 32 else 1
        tiles = max(1, experts) * -(-c // t.block_c) * -(-f // t.block_f)
        live = min(tiles, sms * per_sm)
        waves = -(-tiles // (sms * per_sm))
        tile_bytes = (d * t.block_f * weight_bytes
                      + t.block_c * (d + t.block_f) * dtype_bytes)
        tile_flops = 2.0 * t.block_c * t.block_f * d
        cost = _overhead() + waves * max(
            tile_bytes * live / HBM_BYTES_PER_S,
            tile_flops * max(live, sms) / PEAK_FLOPS)
        scored.append((cost, i, t))
    scored.sort(key=lambda x: x[:2])
    return [t for _, _, t in scored] or list(options[:1])


def gmm_tiles(c: int, *, path: str) -> GmmTiles:
    """The analytic pick: the tile K14 / K15 ran before the tile was a
    choice, on the kernel ``path`` names (``kernels.moe_gmm.ops.path``).
    ``"wgmma"``: one tile height of 64, 128 or 256 rows following C (the
    library's ``wgmma_product`` rule) by 128 columns by 64 deep, as many
    ring stages as fit up to 6 (4 at 256 rows); ``"stream"``: the 8, 16 or
    32 rows C takes by 128 columns by 64 deep, 4 stages; ``"mma"``
    (``gmm_mma_kernel``, K15 at C > 32): 64 x 64 x 64 without a ring;
    ``"cuda_cores"``: 8, 32 or 64 rows by 64 by 64."""
    if path == "wgmma":
        bm = 64 if c <= 64 else (128 if c <= 128 else 256)
        return GmmTiles(bm, 128, 64, 4 if bm == 256 else 6)
    if path == "stream":
        return GmmTiles(8 if c <= 8 else (16 if c <= 16 else 32), 128, 64, 4)
    if path == "mma":
        return GmmTiles(64, 64, 64)
    return GmmTiles(8 if c <= 8 else (32 if c <= 32 else 64), 64, 64)


def microbatch_count(
    global_batch: int,
    *,
    grad_bytes: float,
    topo: GpuTopology = h100_topology(1),
    step_flops: float = 1e15,
    multi_pod: bool = False,
    launch_overhead: float = 25e-6,
) -> int:
    """Gradient-accumulation microbatches, the reference's arithmetic:
    more microbatches overlap the gradient all-reduce with compute but pay
    a launch each; this is Cost(T, N, L) with N = global_batch and B the
    microbatch size.

    ``topo``: any topology with ``total_chips``, ``ici_bw`` and
    ``peak_flops`` (the reference's ``TpuTopology`` values too), by
    default one H100.  ``launch_overhead`` is the
    per-microbatch dispatch cost (the L analogue); the trainer passes the
    calibrated ``TuningContext`` measurement.  On one card the all-reduce
    term is 0 and the count is 1.  Memory is not a term, as in the
    reference."""
    chips = topo.total_chips
    # ring all-reduce wall time of the full gradient (slowest link decides)
    link = topo.ici_bw if not multi_pod else topo.ici_bw / 4  # cross-pod hop
    allreduce = 2.0 * grad_bytes / (chips * link)
    launch = launch_overhead
    compute = step_flops / (chips * topo.peak_flops)
    candidates = [s for s in (1, 2, 4, 8, 16, 32) if s <= global_batch]
    # with s microbatches the reduce of microbatch i overlaps compute of
    # i + 1: exposed comm = one microbatch's share, overhead = s launches
    costs = [
        compute + launch * s + allreduce / s + max(0.0, allreduce - compute)
        for s in candidates
    ]
    return int(candidates[int(np.argmin(costs))])


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
