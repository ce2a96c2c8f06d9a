"""Trainer: the fault-tolerant training loop.

Port of ``repro.train.trainer``:

* checkpoint/restart — async checkpoints every ``ckpt_every`` steps in
  the reference's format (atomic rename + COMMIT stamp; torn saves
  ignored);
* preemption — SIGTERM/SIGINT trigger a synchronous final save before
  exit (``run`` restores the handlers it replaced when it returns);
* restore resumes from the latest committed step, including the data
  stream's position (the step index keys the synthetic data, so the batch
  sequence replays identically);
* stragglers — the data pipeline's prefetch queue and timeout skip, with
  an in-order view so that retried batches are applied in step order.

Parameters live on ``model.device`` and are updated in place by the
optimizer.  With ``shardings=(param_sh, opt_sh)`` (trees of
``distributed.params.Layout``, e.g. ``param_shardings`` and
``tree_shardings`` over the optimizer state) each rank holds its block of
every parameter and moment: ``init_state`` and the restore place them
under the layouts, whatever mesh a checkpoint was saved under (the
reference stores the argument and never reads it, though its docstring
promises this), the step is the sharded one
(``make_train_step(grad_shardings=param_sh)``), and checkpoints are
gathered and written by rank 0.  ``microbatches=None`` takes the count
the tuning context picks (``TuningContext.microbatches``, the reference's
``microbatch_count``) over the cards the batch's rows split across (one
without ``shardings``), reduced to one that splits the global batch
evenly, and logs it.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import runtime as rt
from repro_torch.core.topology import h100_topology
from repro_torch.core.tree import flatten
from repro_torch.distributed import params as psh
from repro_torch.distributed import sharding
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    log_every: int = 10
    microbatches: Optional[int] = 1
    grad_compression: Optional[str] = None
    seed: int = 0


class Trainer:
    def __init__(
        self,
        model: Model,
        opt_cfg: opt_mod.AdamWConfig,
        data_cfg: DataConfig,
        cfg: TrainerConfig,
        *,
        shardings: Optional[tuple] = None,
        log_fn: Callable[[str], None] = print,
    ):
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.log = log_fn
        self.saver = ckpt.AsyncSaver()
        self._preempted = False
        self.microbatches = cfg.microbatches
        self._shardings = None
        if shardings is not None:
            sharding.require_group("Trainer(shardings=...)")
            param_sh, opt_sh = shardings
            self._shardings = {"params": param_sh, "opt": opt_sh}
            _check_opt_layouts(param_sh, opt_sh)
        if self.microbatches is None:
            # grads are f32 leaves shaped like params: the calibrated
            # context turns (bytes, batch) into an accumulation count
            chips = (1 if shardings is None
                     else _batch_ranks(shardings[0]))
            mb = max(1, rt.tuning().microbatches(
                data_cfg.global_batch,
                grad_bytes=4.0 * model.cfg.param_count(),
                topo=h100_topology(chips)))
            while data_cfg.global_batch % mb:   # an even split of the rows
                mb -= 1
            self.microbatches = mb
            self.log(f"[trainer] tuned microbatches={self.microbatches}")
        self._step_fn = make_train_step(
            model, opt_cfg, microbatches=self.microbatches,
            grad_compression=cfg.grad_compression,
            grad_shardings=None if shardings is None else shardings[0])

    # ---- state ----

    def init_state(self):
        """(params, opt_state) from the seed: under ``shardings`` this
        rank's blocks (the moments made at the blocks' shapes)."""
        params = self.model.init(self.cfg.seed)
        if self._shardings is not None:
            params = psh.shard_tree(params, self._shardings["params"])
        opt_state = opt_mod.init_state(params, self.opt_cfg)
        return params, opt_state

    def _save(self, tree, step: int, *, sync: bool) -> None:
        if sync:
            ckpt.save(tree, self.cfg.ckpt_dir, step,
                      shardings=self._shardings)
        else:
            self.saver.save(tree, self.cfg.ckpt_dir, step,
                            shardings=self._shardings)

    def _prune(self) -> None:
        if self._shardings is None or dist.get_rank() == 0:
            ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep_ckpts)

    def _try_restore(self, params, opt_state):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        tree, step = ckpt.restore(
            self.cfg.ckpt_dir, step,
            like={"params": params, "opt": opt_state},
            shardings=self._shardings)
        self.log(f"[trainer] restored checkpoint at step {step}")
        return tree["params"], tree["opt"], step

    def _install_signals(self) -> dict:
        """Route SIGTERM/SIGINT to a preemption save; returns the handlers
        they replace, which ``run`` puts back when it ends."""
        def handler(signum, frame):
            self._preempted = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread (tests)
        return previous

    # ---- loop ----

    @staticmethod
    def _in_order(data, start: int):
        """Reorder-buffer view of the prefetch stream: straggler retries
        arrive out of submission order, but the optimizer walk and the
        checkpoint/restore contract ("step N committed" == all batches
        < N applied, so a restart replays the identical sequence) need
        in-order application."""
        buf = {}
        expect = start
        for step_idx, batch in data:
            buf[step_idx] = batch
            while expect in buf:
                yield expect, buf.pop(expect)
                expect += 1

    def run(self) -> dict:
        previous = self._install_signals()
        try:
            return self._run()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _run(self) -> dict:
        params, opt_state = self.init_state()
        params, opt_state, start = self._try_restore(params, opt_state)
        data = PrefetchIterator(SyntheticLM(self.data_cfg), start_step=start,
                                num_steps=max(0, self.cfg.total_steps - start))
        history = []
        t_last = time.time()
        step = start - 1   # last step actually applied (none yet)
        try:
            for step_idx, batch in self._in_order(data, start):
                if step_idx >= self.cfg.total_steps or self._preempted:
                    break
                batch = {k: torch.as_tensor(v, device=self.model.device)
                         for k, v in batch.items()}
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, batch)
                step = step_idx   # only now has this step been applied
                if (step + 1) % self.cfg.log_every == 0 or step == start:
                    dt = time.time() - t_last
                    t_last = time.time()
                    loss = float(metrics["loss"])
                    history.append((step + 1, loss))
                    self.log(f"[trainer] step {step + 1} "
                             f"loss {loss:.4f} "
                             f"gnorm {float(metrics['grad_norm']):.3f} "
                             f"({dt:.2f}s/{self.cfg.log_every}steps)")
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self._save({"params": params, "opt": opt_state},
                               step + 1, sync=False)
                    self._prune()
        finally:
            data.close()
        # final (or preemption) save, synchronous — skipped when the async
        # saver already committed exactly this step.  ``step`` is the last
        # step applied (start - 1 when the loop never ran), so final_step
        # never claims an untrained batch.
        self.saver.wait()
        final_step = min(step + 1, self.cfg.total_steps)
        if ckpt.latest_step(self.cfg.ckpt_dir) != final_step:
            self._save({"params": params, "opt": opt_state}, final_step,
                       sync=True)
        self._prune()
        if self._preempted:
            self.log(f"[trainer] preempted at step {final_step}; "
                     "state saved for restart")
        return {"params": params, "opt_state": opt_state,
                "history": history, "final_step": final_step,
                "preempted": self._preempted}


def _batch_ranks(param_sh) -> int:
    """The ranks a batch's rows split over under the layouts ``param_sh``:
    the active policy's batch axes, else the tp layout's (the sharded
    step's rule, ``train_step._Sharded.axes``)."""
    mesh = opt_mod.tree_leaves(param_sh)[0].mesh
    pol = sharding.active_policy()
    axes = (pol.batch_axes() if pol is not None and pol.mesh is mesh
            else sharding.batch_axes(mesh, fsdp=False))
    sizes = sharding.axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _check_opt_layouts(param_sh, opt_sh) -> None:
    """The optimizer updates each block of a parameter with the same
    blocks of its moments (and master copy): their layouts must be the
    parameter's."""
    want = flatten(param_sh)
    for name, tree in opt_sh.items():
        if name == "step":
            continue
        for path, lay in flatten(tree).items():
            if (lay.spec, lay.shape) != (want[path].spec, want[path].shape):
                raise ValueError(
                    f"Trainer(shardings=...): opt/{name}/{path} is laid out "
                    f"{lay.spec}, its parameter {want[path].spec}")
