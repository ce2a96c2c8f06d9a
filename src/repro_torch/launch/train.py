"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --steps 200 --batch 8 --seq 128 --microbatches 1

Port of ``repro.launch.train``.  Trains on the card (``--device cuda``,
the default) or on the CPU (``--device cpu``); ``--reduced`` takes the
CPU-scale config.  ``--calibrate`` first runs the fast online FAA-cost
calibration (its refit on ``--device``) and persists it
(``results/calibration_torch.json``, or ``$REPRO_CALIBRATION``).
``--microbatches`` is required: the reference's automatic count waits
for a card-count term (ROADMAP: the measured autotuner's training half
(microbatch count)).
``main`` returns the trainer's result (params, optimizer state, loss
history, final step).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import runtime
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="grad-accumulation count (required)")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--host-threads", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the fast online FAA-cost calibration first "
                         "(persists results/calibration_torch.json)")
    args = ap.parse_args(argv)

    if args.microbatches is None:
        raise NotImplementedError(
            "--microbatches is required: the reference's automatic count "
            "trades launch overhead against a gradient all-reduce one card "
            "does not have (ROADMAP: the measured autotuner's training half "
            "(microbatch count))")
    if args.calibrate:
        ctx = runtime.calibrate(fast=True, device=args.device)
        print(f"[calibrate] {ctx.source}: {ctx.n_points} points, "
              f"fit loss {ctx.fit_loss:.1f}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch,
                          host_threads=args.host_threads)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    tr = Trainer(model, opt_cfg, data_cfg,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir,
                               log_every=args.log_every,
                               microbatches=args.microbatches,
                               grad_compression=args.grad_compression))
    out = tr.run()
    print(f"done at step {out['final_step']}; "
          f"final loss {out['history'][-1][1] if out['history'] else 'n/a'}")
    return out


if __name__ == "__main__":
    main()
