"""Serving launcher: load (or init) a model and run batched generation,
or drive the continuous-batching engine over a mixed-length workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --batch 4 --prompt-len 16 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --requests 16 --tokens 24 --schedule hierarchical --slots 4

Port of ``repro.launch.serve``, with its flags, plus ``--device`` (the
card by default; ``--device cpu`` runs the kernels' plain versions).
The weights come from ``Model.init(0)``, or from ``--ckpt-dir``: a
checkpoint written by either package (``{"params": ...}``, each leaf read
by its manifest's dtype).  ``--page-size 0`` takes the paged cache's page
size from the tuning db.  ``main`` returns what was generated: one token
array per request (``--requests``), else the [batch, tokens] array of
one ``generate``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_dummy_batch
from repro_torch.models import Model
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    # continuous-serving options (--requests > 0 switches to serve())
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N mixed-length requests through the "
                         "continuous engine instead of one generate()")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--schedule", default="faa",
                    help="admission policy (any registered scheduler)")
    ap.add_argument("--mode", default="continuous",
                    choices=("continuous", "rounds"))
    ap.add_argument("--cache", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="KV layout: per-slot max_len rows, or a page "
                         "pool with per-slot page tables + prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged cache only); 0 "
                         "resolves the tuned page size from the tuning db")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool size; default matches the contiguous "
                         "byte budget (slots * max_len / page_size)")
    ap.add_argument("--kv-dtype", default=None,
                    help="quantized KV cache storage, e.g. int8 or "
                         "float8_e4m3fn (default: the compute dtype)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    params = model.init(0)
    if args.ckpt_dir:
        tree, step = ckpt.restore(args.ckpt_dir, like={"params": params})
        params = tree["params"]
        print(f"loaded checkpoint step {step}")

    if args.requests > 0:
        max_len = args.prompt_len + args.tokens + 1
        if args.cache == "paged":       # pool leaves come in whole pages
            round_to = args.page_size or 16
            max_len = -(-max_len // round_to) * round_to
        eng = Engine(model, params, ServeConfig(
            max_len=max_len,
            temperature=args.temperature, slots=args.slots,
            refill_schedule=args.schedule, mode=args.mode,
            cache=args.cache, page_size=args.page_size or None,
            num_pages=args.num_pages, kv_dtype=args.kv_dtype))
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.randint(max(2, args.prompt_len // 4),
                                        args.prompt_len + 1,
                                        args.requests)]
        outs = eng.serve(prompts, args.tokens)
        rep = eng.last_report
        print(f"served {len(outs)} requests x <= {args.tokens} tokens "
              f"[{args.mode}/{args.schedule}] in {rep.wall_s:.2f}s")
        for k, v in rep.as_row().items():
            print(f"  {k:24s} {v}")
        return outs

    eng = Engine(model, params, ServeConfig(
        max_len=args.prompt_len + args.tokens + 1,
        temperature=args.temperature))
    batch = make_dummy_batch(cfg, args.batch, args.prompt_len,
                             device=args.device)
    t0 = time.time()
    out = eng.generate(batch, args.tokens)
    dt = time.time() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s)")
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
