"""Calibration launcher: measure FAA costs on this host, refit the cost
model, persist the result, and report what every layer will now use.

    PYTHONPATH=src python -m repro_torch.launch.calibrate
    PYTHONPATH=src python -m repro_torch.launch.calibrate --fast
    PYTHONPATH=src python -m repro_torch.launch.calibrate --simulate-only
    PYTHONPATH=src python -m repro_torch.launch.calibrate --fast \
        --no-persist --device cpu

``--fast`` is the smaller sweep and a shorter refit; ``--simulate-only``
skips the host microbenchmarks.

Port of ``repro.launch.calibrate``.  The refit runs on the card unless
``--device cpu`` is given.  Writes ``results/calibration_torch.json`` (or
``$REPRO_CALIBRATION``; see ``repro_torch.core.runtime``); every
subsequent process auto-loads it, so the data-pipeline grain, the
``cost_model`` scheduler, serve admission batching, the draft span and
the kernel search's dispatch prior all run on coefficients fitted where
the code runs instead of the paper's Quadro-era weights.  ``main``
returns the calibrated context.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import runtime
from repro_torch.core.atomic_sim import UnitTask
from repro_torch.core.topology import PLATFORMS


def main(argv: Optional[Sequence[str]] = None) -> runtime.TuningContext:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller sweep + shorter refit (CI-scale)")
    ap.add_argument("--simulate-only", action="store_true",
                    help="skip host microbenchmarks; fit on the paper's "
                         "three simulated platforms only")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--restarts", type=int, default=None)
    ap.add_argument("--no-persist", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the refit runs on (default: the card)")
    args = ap.parse_args(argv)

    meas = None
    if not args.simulate_only:
        meas = runtime.measure_host()
        print(f"host: {meas.cores} cores")
        print(f"  FAA round-trip     : {meas.faa_ns:9.1f} ns")
        print(f"  contended transfer : {meas.transfer_ns:9.1f} ns "
              f"({'measured' if meas.transfer_measured else 'fallback ratio'})")
        print(f"  per-item dispatch  : {meas.dispatch_ns:9.1f} ns")

    # the printed measurement IS the one the fit uses (no re-benchmark)
    ctx = runtime.calibrate(
        simulate_only=args.simulate_only, fast=args.fast,
        steps=args.steps, restarts=args.restarts,
        persist=not args.no_persist, measurement=meas, device=args.device)
    print(f"calibration [{ctx.source}]: {ctx.n_points} points, "
          f"fit loss {ctx.fit_loss:.1f}")
    for k, v in ctx.params.items():
        print(f"  {k:8s} {np.asarray(v).round(3)}")
    if not args.no_persist:
        print(f"persisted -> {runtime.calibration_path()}")

    print("\nfitted block sizes vs the event model "
          "(N=512; sim-best in brackets):")
    task = UnitTask()
    for topo in PLATFORMS.values():
        t = topo.total_cores
        row = runtime.ranking_consistency(ctx, topo, t, task)
        feats = cm.WorkloadFeatures(
            core_groups=topo.groups_used(t), threads=t,
            unit_read=task.unit_read, unit_write=task.unit_write,
            unit_comp=task.unit_comp)
        print(f"  {topo.name:22s} T={t:3d}  "
              f"B={ctx.suggest_block(feats, n=512):4d} "
              f"[sim {row['sim_best_block']:4d}]  "
              f"rank-corr {row['spearman_sim_vs_analytic']:+.2f}")
    return ctx


if __name__ == "__main__":
    main()
