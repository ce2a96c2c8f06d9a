"""ParallelFor — the paper's subject, implemented faithfully.

The reference semantics (paper, "Problem statement"): a thread pool in which
every thread claims ``block_size`` iterations at a time from a shared atomic
counter via fetch-and-add, runs ``task(i)`` for each claimed ``i``, and loops
until the counter passes ``N``. ``ParallelFor`` returns once all threads have
drained — the caller is assured ``task`` ran exactly once for every
``i in [0, N)``.

Scheduling policies live in :mod:`repro_torch.core.schedulers` — a
registry, not a branch (``static``, ``faa``, ``guided``, ``cost_model``,
``hierarchical``, ``stealing``; all exactly-once, all tested).
:func:`parallel_for_stats` returns the full
:class:`~repro_torch.core.schedulers.ScheduleStats` telemetry (FAA calls
total / shared / per-thread, claim-size histogram, imbalance);
:func:`parallel_for` is the seed-compatible wrapper returning the bare FAA
count.

On-device ParallelFor lives in :func:`device_parallel_for`: N work items
spread over the ranks of one axis of a ``torch.distributed`` device mesh,
where the FAA is replaced by deterministic claiming — so each scheduling
policy maps to a shard *layout* whose block size plays the identical role
(see ``_device_block_size``).  Port of ``repro.core.parallel_for``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cost_model as _cm
from repro_torch.core import faults as _faults
from repro_torch.core import runtime as _rt
from repro_torch.core import schedulers as _sched
from repro_torch.core.schedulers import (AtomicCounter, ScheduleStats,
                                         Scheduler, ThreadPool)
from repro_torch.distributed import sharding

__all__ = [
    "AtomicCounter",
    "ThreadPool",
    "parallel_for",
    "parallel_for_stats",
    "block_cyclic_assignment",
    "device_parallel_for",
    "grain_sizes",
]


def parallel_for_stats(
    task: Callable[[int], None],
    n: int,
    *,
    pool: Optional[ThreadPool] = None,
    n_threads: int = 4,
    schedule: Union[str, Scheduler] = "faa",
    block_size: Optional[int] = None,
    cost_inputs: Optional[_cm.WorkloadFeatures] = None,
    layer: str = "parallel_for",
) -> ScheduleStats:
    """Run ``task(i)`` for every i in [0, n) under the named scheduling
    policy; returns the run's full :class:`ScheduleStats` telemetry.

    ``schedule`` is a registered policy name or a pre-configured
    :class:`Scheduler` instance (e.g. ``HierarchicalScheduler(groups=8)``).

    With no explicit ``pool`` the call runs on the process-wide persistent
    :class:`repro_torch.core.runtime.WorkerPool` — steady-state calls spawn
    no threads.  ``layer`` tags the run in the pool's cross-layer telemetry
    (``repro_torch.core.runtime.telemetry()``).
    """
    if n < 0:
        raise ValueError("n must be >= 0")
    sched = _sched.get_scheduler(schedule)
    pool = pool or _rt.get_pool().scoped(n_threads)
    # fault injection resolves at the call boundary: one global read when
    # no plan is installed (the zero-overhead contract), a task wrapper at
    # the claim boundary when this run's layer is targeted
    inj = _faults.active()
    run_faults = inj.for_layer(layer) if inj is not None else None
    if run_faults is not None:
        task = run_faults.wrap(task)
    if n == 0:
        stats = _sched.empty_stats(sched.name, pool.n_threads)
    else:
        stats = sched.run(task, n, pool, block_size=block_size,
                          cost_inputs=cost_inputs)
    if run_faults is not None:
        stats.injected_stall_s += run_faults.stall_s
        stats.injected_faults += run_faults.fired
    _rt.record_stats(layer, stats)
    return stats


def parallel_for(
    task: Callable[[int], None],
    n: int,
    *,
    pool: Optional[ThreadPool] = None,
    n_threads: int = 4,
    schedule: Union[str, Scheduler] = "faa",
    block_size: Optional[int] = None,
    cost_inputs: Optional[_cm.WorkloadFeatures] = None,
    layer: str = "parallel_for",
) -> int:
    """Seed-compatible wrapper: run and return the number of atomic FAA
    calls issued (the paper's cost driver).  Use
    :func:`parallel_for_stats` for the structured telemetry."""
    return parallel_for_stats(
        task, n, pool=pool, n_threads=n_threads, schedule=schedule,
        block_size=block_size, cost_inputs=cost_inputs, layer=layer,
    ).faa_total


def block_cyclic_assignment(n: int, block_size: int,
                            workers: int) -> np.ndarray:
    """Deterministic replacement for FAA claiming: block k goes to worker
    ``k % workers``. Returns an int array [n] with the owning worker of each
    iteration — the claim order FAA would produce under perfect balance."""
    blocks = -(-n // block_size)
    owner_of_block = np.arange(blocks) % workers
    return np.repeat(owner_of_block, block_size)[:n]


def _device_block_size(
    schedule: Union[str, Scheduler],
    n: int,
    workers: int,
    block_size: Optional[int],
    cost_inputs: Optional[_cm.WorkloadFeatures],
) -> int:
    """Map a scheduling policy onto the block-cyclic shard layout's block.

    On device the claim is static, so a policy is exactly its layout; the
    block size comes from the registered policy's
    :meth:`~repro_torch.core.schedulers.Scheduler.device_block_size` hook
    (static → one contiguous range per worker; faa → the requested B;
    guided → the mean guided chunk; cost_model → the trained model;
    hierarchical → super-blocks stay with one worker; stealing and custom
    policies → fine blocks for balance).
    """
    sched = _sched.get_scheduler(schedule)
    b = int(sched.device_block_size(n, workers, block_size, cost_inputs))
    return max(1, min(b, n))


def device_parallel_for(
    fn: Callable[[torch.Tensor], torch.Tensor],
    items: torch.Tensor,
    *,
    mesh,
    axis: str = "data",
    block_size: Optional[int] = None,
    schedule: Union[str, Scheduler] = "faa",
    cost_inputs: Optional[_cm.WorkloadFeatures] = None,
) -> torch.Tensor:
    """Map ``fn`` over the leading axis of ``items`` with the work
    distributed over ``axis`` of ``mesh`` (a ``DeviceMesh``) in the layout
    of ``schedule``.

    Iterations are the rows of ``items``, which every rank of the axis
    passes whole (the reference's global array); the claim is a static
    block-cyclic layout (the contention-free FAA replacement), whose block
    size controls the shard granularity as the paper's B does, and the
    scheduling policy picks the layout (``_device_block_size``).  The rows
    are padded to whole blocks and the blocks to a multiple of the
    workers; worker w runs ``torch.func.vmap(torch.func.vmap(fn))`` on its
    contiguous run of blocks w, w + workers, ...; the runs are gathered
    over the axis, put back in order and cut to ``n``.  Every rank returns
    the whole output, as the reference returns a global array.
    """
    n = items.shape[0]
    workers = sharding.axis_sizes(mesh)[axis]
    b = _device_block_size(schedule, n, workers, block_size, cost_inputs)
    blocks = -(-n // b)
    pad = blocks * b - n
    if pad:
        items = torch.cat([items, items.new_zeros((pad,) + items.shape[1:])])
    # [blocks, b, ...] block-cyclic: permute blocks so worker w holds blocks
    # w, w+workers, w+2*workers, ... contiguously.
    blocked = items.reshape(blocks, b, *items.shape[1:])
    pad_blocks = (-blocks) % workers
    if pad_blocks:
        blocked = torch.cat(
            [blocked, blocked.new_zeros((pad_blocks,) + blocked.shape[1:])])
        blocks += pad_blocks
    perm = np.argsort(np.arange(blocks) % workers, kind="stable")
    blocked = blocked[torch.from_numpy(perm).to(blocked.device)]
    per = blocks // workers
    me = sharding.coordinate(mesh)[axis]
    out = torch.func.vmap(torch.func.vmap(fn))(
        blocked[me * per:(me + 1) * per]).contiguous()
    if workers > 1:
        runs = out.new_empty((workers * out.numel(),))
        dist.all_gather_into_tensor(runs, out.view(-1),
                                    group=sharding.group_of(mesh, (axis,)))
        out = runs.view(blocks, *out.shape[1:])
    inv = np.argsort(perm, kind="stable")
    out = out[torch.from_numpy(inv).to(out.device)]
    return out.reshape(blocks * b, *out.shape[2:])[:n]


def grain_sizes(n: int, block_size: int) -> List[tuple[int, int]]:
    """[(begin, end)] blocks of the iteration space — shared helper."""
    return [(i, min(n, i + block_size)) for i in range(0, n, block_size)]
