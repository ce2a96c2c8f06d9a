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
optimizer.  Sharded state (``shardings``) and an automatic microbatch
count (``microbatches=None``) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
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
        if shardings is not None:
            raise NotImplementedError(
                "Trainer(shardings=...): no sharded training in the port "
                "yet (ROADMAP: distributed and launch)")
        if cfg.microbatches is None:
            raise NotImplementedError(
                "TrainerConfig(microbatches=None): the reference picks the "
                "count with autotune.microbatch_count from TPU ICI and peak "
                "constants; the port needs Hopper's (ROADMAP: the pipelined "
                "kernels and the measured autotuner) — pass a count")
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.log = log_fn
        self.saver = ckpt.AsyncSaver()
        self._preempted = False
        self.microbatches = cfg.microbatches
        self._step_fn = make_train_step(
            model, opt_cfg, microbatches=self.microbatches,
            grad_compression=cfg.grad_compression)

    # ---- state ----

    def init_state(self):
        params = self.model.init(self.cfg.seed)
        opt_state = opt_mod.init_state(params, self.opt_cfg)
        return params, opt_state

    def _try_restore(self, params, opt_state):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        tree, step = ckpt.restore(
            self.cfg.ckpt_dir, step,
            like={"params": params, "opt": opt_state})
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
                    self.saver.save({"params": params, "opt": opt_state},
                                    self.cfg.ckpt_dir, step + 1)
                    ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep_ckpts)
        finally:
            data.close()
        # final (or preemption) save, synchronous — skipped when the async
        # saver already committed exactly this step.  ``step`` is the last
        # step applied (start - 1 when the loop never ran), so final_step
        # never claims an untrained batch.
        self.saver.wait()
        final_step = min(step + 1, self.cfg.total_steps)
        if ckpt.latest_step(self.cfg.ckpt_dir) != final_step:
            ckpt.save({"params": params, "opt": opt_state},
                      self.cfg.ckpt_dir, final_step)
        ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep_ckpts)
        if self._preempted:
            self.log(f"[trainer] preempted at step {final_step}; "
                     "state saved for restart")
        return {"params": params, "opt_state": opt_state,
                "history": history, "final_step": final_step,
                "preempted": self._preempted}
