"""Synthetic-token data pipeline with a ParallelFor-scheduled host stage.

Port of ``repro.data.pipeline`` (a copy; numpy and the port's core only).
The host preprocessing stage (detokenization/packing stand-in) runs under
:func:`repro_torch.core.parallel_for.parallel_for` with the grain size
chosen by the paper's cost model (`autotune.data_grain_size`) — the host
IS a multicore CPU, so the paper applies literally here.  A prefetch
producer on the shared runtime
:class:`~repro_torch.core.runtime.WorkerPool` keeps a bounded queue ahead
of the training loop; a batch timeout provides straggler mitigation (slow
shards are skipped, re-queued, and retried — never stalling the step).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import autotune, cost_model as cm, parallel_for as pf
from repro_torch.core import runtime as rt


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_threads: int = 4
    prefetch: int = 2
    grain_size: Optional[int] = None     # None = cost-model choice
    schedule: str = "faa"                # any registered scheduler policy
    straggler_timeout_s: float = 30.0


class SyntheticLM:
    """Deterministic synthetic corpus: per-example zipf-ish token draws.

    Each example is derived from (seed, index) only, so any host can
    materialize any shard — this is what makes elastic re-sharding and
    straggler skip safe (exactly-once per index is the ParallelFor
    guarantee of every scheduler policy).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # zipf-ish ranks; clip to vocab
        self._ranks = None
        # telemetry of the most recent batch's ParallelFor (FAA counts,
        # imbalance) — observable by trainers/benchmarks
        self.last_schedule_stats = None

    def example(self, index: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + index) % 2**31)
        u = rng.random_sample(cfg.seq_len)
        # inverse-CDF of a truncated zipf(1.1)
        toks = np.floor((u ** -1.35 - 1.0)).astype(np.int64) % cfg.vocab_size
        return toks.astype(np.int32)

    def batch(self, step: int) -> dict:
        """Materialize batch `step` with a ParallelFor over examples."""
        cfg = self.cfg
        out = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        base = step * cfg.global_batch
        grain = cfg.grain_size
        cost_inputs = None
        if grain is None:
            if cfg.schedule == "cost_model":
                # hand the policy the same features data_grain_size uses and
                # let it consult the model itself — an explicit block_size
                # would silently override the predictor
                cost_inputs = cm.WorkloadFeatures(
                    core_groups=1, threads=cfg.host_threads,
                    unit_read=4 * cfg.seq_len, unit_write=4 * cfg.seq_len,
                    unit_comp=1024)
            else:
                grain = autotune.data_grain_size(
                    cfg.global_batch, host_threads=cfg.host_threads,
                    bytes_per_example=4 * cfg.seq_len)

        def task(i: int) -> None:
            out[i] = self.example(base + i)

        self.last_schedule_stats = pf.parallel_for_stats(
            task, cfg.global_batch, n_threads=cfg.host_threads,
            schedule=cfg.schedule, block_size=grain,
            cost_inputs=cost_inputs, layer="data")
        return {"tokens": out}


class PrefetchIterator:
    """Bounded-queue prefetch + straggler mitigation, with a bounded step
    range and real straggler re-queue.

    The producer runs on the process-wide persistent
    :class:`repro_torch.core.runtime.WorkerPool` (no per-iterator thread
    spawn).
    If producing a batch exceeds ``straggler_timeout_s`` (slow shard / bad
    host) its index is pushed to the back of the retry list and the next
    index is served first — training never stalls on one straggler.
    Skipped indices ARE retried: the next retry is produced after the next
    fresh batch lands (and at the end of a bounded stream), and a retried
    batch is delivered even if it is slow again (``stragglers`` records
    every skip for telemetry).

    ``num_steps`` bounds the stream: the producer emits steps
    ``[start_step, start_step + num_steps)`` — retried stragglers
    included — then finishes, and iteration raises ``StopIteration`` once
    the queue drains.  ``num_steps=None`` keeps the unbounded stream.
    """

    def __init__(self, dataset: SyntheticLM, start_step: int = 0,
                 num_steps: Optional[int] = None):
        self.dataset = dataset
        self.cfg = dataset.cfg
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        self._step = start_step
        self._end = None if num_steps is None else start_step + num_steps
        self._stop = threading.Event()
        self._done = threading.Event()
        self._retry: list[int] = []
        self.stragglers: list[int] = []   # every skipped (then retried) step
        # done fires after the worker is idle again, so a close() followed
        # by new pool work never races the idle accounting into a spawn
        rt.get_pool().submit(self._producer, on_done=self._done.set)

    def _next_index(self, step: int, fresh_since_retry: int):
        """(index, is_retry, next_step): retries drain after each fresh
        batch, and unconditionally once the fresh range is exhausted."""
        fresh_left = self._end is None or step < self._end
        if self._retry and (not fresh_left or fresh_since_retry > 0):
            return self._retry.pop(0), True, step
        if fresh_left:
            return step, False, step + 1
        return None, False, step

    def _producer(self):
        step = self._step
        fresh_since_retry = 0
        while not self._stop.is_set():
            idx, is_retry, step = self._next_index(step, fresh_since_retry)
            if idx is None:
                return
            if is_retry:
                fresh_since_retry = 0
            t0 = time.monotonic()
            batch = self.dataset.batch(idx)
            slow = time.monotonic() - t0 > self.cfg.straggler_timeout_s
            if slow and not is_retry:
                # skip: serve the next index first, re-queue this one
                self.stragglers.append(idx)
                self._retry.append(idx)
                fresh_since_retry = 0
                continue
            if not is_retry:
                fresh_since_retry += 1
            while not self._stop.is_set():
                try:
                    self._q.put((idx, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if self._done.is_set():
                    # the producer may have put its last batch between our
                    # timeout and the done flag: drain before stopping
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        raise StopIteration from None
                continue

    def close(self):
        self._stop.set()
        self._done.wait(timeout=2.0)
