"""Kernel autotune launcher: the measured search for the kernels'
template knobs on the card, persisted to the tuning database.

    PYTHONPATH=src python -m repro_torch.launch.tune            # all five
    PYTHONPATH=src python -m repro_torch.launch.tune --kernel flash_attention
    PYTHONPATH=src python -m repro_torch.launch.tune --no-persist
    PYTHONPATH=src python -m repro_torch.launch.tune --quick --device cpu

Port of ``repro.launch.tune``.  Writes ``results/tuning_db_torch.json``
(or ``$REPRO_TORCH_TUNING_DB``; see ``repro_torch.core.autotune_search``);
every later process resolves the kernels' ring depth, split count, flash
tile, open page size, expert-matmul tile and SSD chunk from it with zero
timed measurements — the serve engine
and the trainer inherit the tuned configs the moment they call the ops.
The search is prior-pruned: the analytic cost model ranks the
candidates, and only the top-k meet the clock.  It runs on the card
unless ``--device cpu`` is given, where it times the plain versions at
``--quick``'s tiny shapes (the machinery, not a winner).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import autotune_search
from repro_torch.core.autotune_search import SearchOptions, TuningDB


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default=None,
                    choices=sorted(autotune_search.SPECS),
                    help="tune one kernel (default: all five)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes + shallow search (CPU-scale)")
    ap.add_argument("--no-persist", action="store_true",
                    help="search in memory only; leave the db untouched")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed samples per candidate (median wins)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="candidates kept from the analytic prior")
    ap.add_argument("--device", default="cuda",
                    help="the device searched on (default: the card)")
    args = ap.parse_args(argv)

    shapes = (autotune_search.QUICK_SHAPES if args.quick
              else autotune_search.REPRESENTATIVE_SHAPES)
    kernels = [args.kernel] if args.kernel else sorted(shapes)
    defaults = SearchOptions()
    options = SearchOptions(
        top_k=args.top_k if args.top_k else (4 if args.quick
                                             else defaults.top_k),
        reps=args.reps if args.reps else (2 if args.quick
                                          else defaults.reps))
    db = TuningDB() if args.no_persist else autotune_search.get_db()
    return run(kernels, shapes, db=db, options=options, device=args.device)


def run(kernels, shapes, *, db: TuningDB, options: SearchOptions,
        device="cuda") -> list:
    """Search each kernel's shapes into ``db`` and print the table (the
    reference's columns, then ms(c): the classic config a cache miss
    runs); returns the search results.  A shape whose bucket this run
    already searched (deepseek's decode gate / up and down products share
    one) is skipped."""
    print(f"backend={autotune_search.backend_name(device)} "
          f"mode={autotune_search.mode()} "
          f"db={'memory' if db.path is None else db.path}")
    print(f"{'kernel':22s} {'bucket':58s} {'analytic':30s} "
          f"{'tuned':30s} {'ms(a)':>9s} {'ms(t)':>9s} "
          f"{'speedup':>7s} {'timed':>5s} {'ms(c)':>9s}")
    results, seen = [], set()
    for kernel in kernels:
        spec = autotune_search.SPECS[kernel]
        for shape in shapes[kernel]:
            key = (kernel, spec.bucket_key(spec.bucket(**shape)))
            if key in seen:
                continue
            seen.add(key)
            res = autotune_search.search_kernel(
                kernel, db=db, options=options, device=device, **shape)
            results.append(res)
            print(f"{kernel:22s} {res.bucket:58s} "
                  f"{autotune_search.fmt_items(res.analytic_config):30s} "
                  f"{autotune_search.fmt_items(res.config):30s} "
                  f"{res.analytic_s * 1e3:9.4f} {res.measured_s * 1e3:9.4f} "
                  f"{res.speedup:6.2f}x {res.n_timed:5d} "
                  f"{classic_ms(spec, shape, res):>9s}", flush=True)
    if db.path is not None:
        print(f"persisted {len(db)} entries -> {db.path}")
        print("steady-state lookups now resolve these buckets with zero "
              "measurements")
    return results


def classic_ms(spec, shape: dict, res) -> str:
    """The measured ms of the config a cache miss runs (the search keeps
    it in slot 0 or 1, so it is always timed), as the table prints it."""
    classic = spec.analytic(spec.bucket(**shape))
    return next((f"{t.median_s * 1e3:.4f}" for t in res.trials
                 if t.config == classic), "-")


if __name__ == "__main__":
    main()
