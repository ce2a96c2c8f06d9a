#!/usr/bin/env python3
"""Host microseconds per call of the port's attention ops at the serve's
main-path shapes, for holding one tree's host cost to another's on the
card.

    PYTHONPATH=<tree>/src python3 tools/route_overhead.py LABEL [OUT.json]

Imports ``repro_torch`` from the path given and times, for K1's prefill
(bf16, Sq 512 into a 1024-row cache), K2's decode (B 8, 16/2 heads,
D 128, S 1024), K3's paged decode (ps 16, a 513-page pool) and K8's
(int8 pages), the host's time per call: ``CALLS`` calls queued back to
back behind a sleep kernel (so the host never waits for the card), on the
host clock, the median of ``REPS`` such batches.  Where the tree has the
tuning db (``repro_torch.core.autotune_search``) it does so under each
resolution a call can take, every one launching the classic kernels:
``off`` (``REPRO_TUNING=off``), ``miss`` (mode on, an empty db) and
``hit`` (mode on, a db holding the classic config for each bucket), the
modes' batches taken in turns so that they share the host's drift; and
it times the resolution alone (``fa.route`` / ``da.route``, no launch),
once memoized and once resolved afresh (the memo cleared every call).
Prints one JSON object as its last line, and writes it to OUT.json if
given.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

CALLS = 200
REPS = 15
ROUTE_CALLS = 2000
HOLD_CYCLES = 200_000_000      # ~0.1 s at 1.98 GHz: longer than queueing


def _inputs():
    from repro_torch.kernels import quant

    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()

    kv_len = torch.tensor([489, 117, 1024, 1024, 353, 40, 300, 777],
                          dtype=torch.int32).cuda()
    pt = (torch.randperm(512, generator=gen).reshape(8, 64) + 1).to(
        torch.int32).cuda()
    pool_k, pool_v = randn(513, 16, 2, 128), randn(513, 16, 2, 128)
    kq, ks = quant.quantize(pool_k, dtype=torch.int8,
                            scale_dtype=quant.SCALE_DTYPE)
    vq, vs = quant.quantize(pool_v, dtype=torch.int8,
                            scale_dtype=quant.SCALE_DTYPE)
    return {
        "prefill": (randn(1, 512, 16, 128), randn(1, 1024, 2, 128),
                    randn(1, 1024, 2, 128)),
        "decode": (randn(8, 16, 128), randn(8, 1024, 2, 128),
                   randn(8, 1024, 2, 128), kv_len),
        "paged": (randn(8, 16, 128), pool_k, pool_v, pt, kv_len),
        "paged_int8": (randn(8, 16, 128), kq, ks, vq, vs, pt, kv_len),
    }


def _calls(fa, da, ins):
    return {
        "prefill": lambda: fa.flash_attention(*ins["prefill"], kv_len=512,
                                              q_offset=0),
        "decode": lambda: da.decode_attention(*ins["decode"]),
        "paged": lambda: da.paged_decode_attention(*ins["paged"]),
        "paged_int8": lambda: da.paged_decode_attention_quantized(
            *ins["paged_int8"]),
    }


def batch_us(fn) -> float:
    """Host microseconds per call of one batch of CALLS."""
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    took = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return took


def host_us(calls: dict, modes: dict) -> dict:
    """{mode: {op: median host us per call}}: REPS rounds, each taking
    one batch of every (mode, op) in turn; ``modes`` maps a mode to the
    function that installs it."""
    samples = {m: {op: [] for op in calls} for m in modes}
    for rep in range(REPS + 1):            # round 0 warms up
        for mode, install in modes.items():
            install()
            for op, fn in calls.items():
                took = batch_us(fn)
                if rep:
                    samples[mode][op].append(took)
    return {m: {op: statistics.median(v) for op, v in row.items()}
            for m, row in samples.items()}


def route_us(fn, clear=None) -> float:
    """Median microseconds of one resolution (no launch)."""
    samples = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ROUTE_CALLS):
            if clear is not None:
                clear()
            fn()
        samples.append((time.perf_counter() - t0) / ROUTE_CALLS * 1e6)
    return statistics.median(samples)


def _classic_db(autotune_search, da):
    """A db holding, for each main-path bucket, the config a miss runs."""
    db = autotune_search.TuningDB()
    backend = autotune_search.backend_name("cuda")
    shapes = {
        "flash_attention": dict(sq=512, skv=1024, d=128, dv=128,
                                dtype="bfloat16", causal=True),
        "decode_attention": dict(s=1024, d=128, dv=128, dtype="bfloat16",
                                 rows=16),
    }
    for store in ("bfloat16", "int8"):
        shapes[f"paged_decode_attention|{store}"] = dict(
            s=1024, page_size=16, d=128, dv=128, dtype=store, rows=16)
    for name, shape in shapes.items():
        kernel = name.split("|")[0]
        spec = autotune_search.SPECS[kernel]
        db.record(kernel, backend, spec.bucket_key(spec.bucket(**shape)),
                  autotune_search.analytic_config(kernel, **shape))
    return db


def main(argv) -> dict:
    label = argv[0]
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    ins = _inputs()
    calls = _calls(fa, da, ins)
    result = {"label": label, "calls": CALLS, "reps": REPS, "host_us": {}}
    try:
        from repro_torch.core import autotune_search
    except ImportError:          # a tree from before the tuning db
        autotune_search = None
    if autotune_search is None:
        result["host_us"] = host_us(calls, {"untuned": lambda: None})
    else:
        modes = {"off": ("off", None), "miss": ("on", autotune_search
                                                .TuningDB()),
                 "hit": ("on", _classic_db(autotune_search, da))}

        def installer(env, db):
            def install():
                os.environ["REPRO_TUNING"] = env
                autotune_search.set_db(db)
            return install

        result["host_us"] = host_us(calls, {
            name: installer(env, db) for name, (env, db) in modes.items()})
        q, k, v = ins["prefill"]
        qd, kd, vd, _ = ins["decode"]
        route_fns = {"flash": (lambda: fa.route(q, k, v), fa._ROUTES),
                     "decode": (lambda: da.route(qd, kd, vd), da._ROUTES)}
        result["route_us"] = {}
        for name, (env, db) in modes.items():
            os.environ["REPRO_TUNING"] = env
            autotune_search.set_db(db)
            result["route_us"][name] = {
                f"{op}_{how}": route_us(fn, memo.clear if how == "fresh"
                                        else None)
                for op, (fn, memo) in route_fns.items()
                for how in ("memo", "fresh")}
    result["device"] = torch.cuda.get_device_name(0)
    for mode, row in result["host_us"].items():
        print(label, mode, " ".join(f"{k}={v:.2f}us" for k, v in row.items()))
    for mode, row in result.get("route_us", {}).items():
        print(label, "route", mode,
              " ".join(f"{k}={v:.2f}us" for k, v in row.items()))
    line = json.dumps(result)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            f.write(line + "\n")
    print(line)
    return result


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("route_overhead: needs a CUDA device")
    main(sys.argv[1:])
