#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each:

1. device and build: the card's name and power limit, and the time to
   build every kernel of the serve path from ``src/repro_torch/csrc``;
2. K1 (flash-attention forward) against its plain PyTorch version at the
   prefill shapes of the serve path, in bf16 and f32;
3. K2 (split-K decode) against its plain version with ragged lengths;
4. a reduced f32 qwen2.5-3b served on the card through the kernels,
   against the same serve on the CPU through the plain versions;
5. full-width qwen2.5-3b in bf16 (random weights from the seed) serving
   16 requests through 8 slots — the main path; every kernel must have
   been launched;
6. each kernel's time at its main-path shape beside its bound, its plain
   version's time and one PyTorch library call's time.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory without the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
KERNELS = ("flash_attention", "decode_attention")
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate, f32 rate outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Kernel-vs-plain tolerances (absolute, inputs ~ N(0, 1)).  f32: the two
# differ only in summation order.  bf16: both round their f32 result to
# bf16 once, so they may differ by one bf16 ulp (2^-7 for |out| < 2).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Reduced model on the card vs on the CPU, f32 logits.
LOGIT_TOL = 1e-4


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device ms per call: CUDA events around ``iters`` calls that cycle
    through ``arg_sets`` (together larger than the 50 MB L2, so each call
    finds its inputs cold, as a layer of the model does), after a warm-up.
    The stream is first held by a ~0.1 s sleep kernel while the calls are
    queued, so the host's launch time does not show as gaps between them."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)       # cycles: ~0.1 s at 1.98 GHz
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int) -> float:
    """Host ms per call of ``fn`` (each ending in a device sync), after
    one warm-up call: what a caller waits, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------- phase 2/3

def check_flash(fa, gen) -> dict:
    """K1 vs plain: B=1, Hq=16, Hkv=2, D=128, Skv=1024; Sq in {16, 512}
    with kv_len = Sq and q_offset = 0 (the serve prefill), and once with
    the defaults (suffix alignment)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(16, 16, 0), (512, 512, 0), (512, None, None)]
        for sq, kv_len, q_offset in cases:
            q = randn(gen, (1, sq, 16, 128), dtype)
            k = randn(gen, (1, 1024, 2, 128), dtype)
            v = randn(gen, (1, 1024, 2, 128), dtype)
            out, lse = fa.flash_attention(q, k, v, kv_len=kv_len,
                                          q_offset=q_offset)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_plain(
                q, k, v, kv_len=kv_len, q_offset=q_offset)
            err = max_err(out, ref)
            expect(err <= TOL[dtype] and max_err(lse, ref_lse) <= 1e-3,
                   f"K1 {dtype} sq={sq} kv_len={kv_len}: err {err}")
            errs[(dtype, sq, kv_len)] = err
    say("2 K1 vs plain", **{f"{str(d)[6:]}_sq{s}_kv{kl}": f"{e:.3g}"
                            for (d, s, kl), e in errs.items()})
    return errs


def check_decode(da, gen) -> dict:
    """K2 vs plain: B=8, Hq=16, Hkv=2, D=128, S=1024, ragged kv_len: 1,
    100 (splits past it are wholly masked), 2000 (above S), ..."""
    kv_len = torch.tensor([1, 100, 1024, 2000, 513, 64, 300, 777],
                          dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = randn(gen, (8, 16, 128), dtype)
        k = randn(gen, (8, 1024, 2, 128), dtype)
        v = randn(gen, (8, 1024, 2, 128), dtype)
        out = da.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        err = max_err(out, da.decode_attention_plain(q, k, v, kv_len))
        expect(err <= TOL[dtype], f"K2 {dtype}: err {err}")
        errs[dtype] = err
    splits = da.num_splits(8, 2, 1024, torch.cuda.get_device_properties(
        0).multi_processor_count)
    say("3 K2 vs plain", splits=splits, kv_len=kv_len.tolist(),
        **{str(d)[6:]: f"{e:.3g}" for d, e in errs.items()})
    return errs


# ------------------------------------------------------------------ phase 4

def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def check_reduced_model(get_config, Model, Engine, ServeConfig) -> None:
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED)
    toks = rng.randint(1, cfg.vocab_size, (3, 32)).astype(np.int32)
    lens = np.array([32, 17, 5], np.int32)
    batch = {"tokens": toks, "lengths": lens}
    lc, cc = cpu.prefill_padded(params_cpu, batch, 64, torch.float32)
    lg, cg = gpu.prefill_padded(params_gpu, batch, 64, torch.float32)
    prefill_err = max_err(lg.cpu(), lc)
    nxt = rng.randint(1, cfg.vocab_size, (3, 1)).astype(np.int32)
    dc, _ = cpu.decode_step(params_cpu, nxt, cc)
    dg, _ = gpu.decode_step(params_gpu, nxt, cg)
    decode_err = max_err(dg.cpu(), dc)
    expect(prefill_err <= LOGIT_TOL and decode_err <= LOGIT_TOL,
           f"reduced logits: prefill {prefill_err}, decode {decode_err}")
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 10)]
    scfg = ServeConfig(max_len=64, slots=4, refill_schedule="faa")
    out_cpu = Engine(cpu, params_cpu, scfg).serve(prompts, 12)
    out_gpu = Engine(gpu, params_gpu, scfg).serve(prompts, 12)
    same = all(np.array_equal(a, b) for a, b in zip(out_cpu, out_gpu))
    expect(same, "reduced serve: card tokens differ from the plain path")
    say("4 reduced f32 serve", prefill_logit_err=f"{prefill_err:.3g}",
        decode_logit_err=f"{decode_err:.3g}", requests=len(prompts),
        tokens_equal=same)


# ------------------------------------------------------------------ phase 5

def _category(kernel: str) -> str:
    name = kernel.lower()
    if "fa_fwd_kernel" in name:
        return "k1"
    if "decode_split_kernel" in name or "decode_combine_kernel" in name:
        return "k2"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def profile(fn, iters: int) -> dict:
    """``fn`` timed on the host clock without a profiler (``wall_ms``),
    then one call under torch.profiler: the device time of its kernels by
    category (our K1/K2, matrix products, all other kernels), their
    number, and the device's idle share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wall = wall_ms(fn, iters)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {"k1": 0.0, "k2": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms[_category(ev.name)] += ev.device_time_total / 1e3
            kernels += 1
    busy = sum(ms.values())
    if busy == 0:
        return {"wall_ms": f"{wall:.2f}", "device_ms": "not measured"}
    return {"wall_ms": f"{wall:.2f}", "device_ms": f"{busy:.2f}",
            "idle_share": f"{max(0.0, 1 - busy / wall):.3f}",
            "kernels": kernels, **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()}}


def serve_full_width(get_config, Model, Engine, ServeConfig, fa, da) -> dict:
    cfg = get_config("qwen2.5-3b").with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    t0 = time.monotonic()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 513, 16)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    eng = Engine(model, params, ServeConfig(
        max_len=1024, slots=8, refill_schedule="faa",
        cache_dtype="bfloat16"))
    eng.serve(prompts[:2], 2)                     # warm-up (cuBLAS, caches)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    outs = eng.serve(prompts, 32)                 # the main path
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": da.decode_attention.launches}
    rep = eng.last_report
    for name, n in launches.items():
        expect(n > 0, f"{name} was never launched on the main path")
    expect(len(outs) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs), "full-width serve: malformed outputs")
    # per-phase times, outside the counted run: one 512-wide prefill and
    # one decode tick of the 8-slot batch (each ends in a host sync)
    toks = np.zeros((1, 512), np.int32)
    toks[0] = rng.randint(0, cfg.vocab_size, 512)

    def prefill():
        return eng._prefill_padded(params, toks, np.array([512], np.int32))

    logits, _ = prefill()
    expect(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tick = np.zeros((8, 1), np.int32)
    decode = profile(
        lambda: model.decode_step(params, tick, eng._backend.cache), 10)
    say("5 profile decode tick (8 slots)", **decode)
    pre = profile(prefill, 5)
    say("5 profile prefill (width 512)", **pre)
    result = dict(
        requests=len(prompts), prompt_lens=f"{lens.min()}-{lens.max()}",
        tokens=rep.total_tokens, ticks=rep.total_ticks,
        wall_s=f"{rep.wall_s:.3f}",
        tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
        prefill_ms_w512=pre["wall_ms"], decode_ms_per_tick=decode["wall_ms"],
        init_s=f"{init_s:.1f}",
        launches_flash=launches["flash_attention"],
        launches_decode=launches["decode_attention"])
    say("5 full-width bf16 serve", **result)
    del params, eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "serve_lens": lens}


# ------------------------------------------------------------------ phase 6

def kernel_rows(fa, da, gen, launches, errs_fa, errs_da, serve_lens) -> list:
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []

    # K1 at the serve prefill shape: one 512-token prompt against the
    # 1024-row cache, kv_len = 512, q_offset = 0.
    b, sq, skv, hq, hkv, d, kvl = 1, 512, 1024, 16, 2, 128, 512
    sets = [(randn(gen, (b, sq, hq, d), bf16), randn(gen, (b, skv, hkv, d), bf16),
             randn(gen, (b, skv, hkv, d), bf16)) for _ in range(16)]
    ms = time_ms(lambda q, k, v: fa.flash_attention(
        q, k, v, kv_len=kvl, q_offset=0), sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, kv_len=kvl, q_offset=0), sets, iters=5)
    lib_sets = [(q.transpose(1, 2), k[:, :kvl].transpose(1, 2),
                 v[:, :kvl].transpose(1, 2)) for q, k, v in sets]
    lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True), lib_sets)
    pairs = sum(min(i + 1, kvl) for i in range(sq))        # causal (q, k)
    flops = 4 * d * hq * b * pairs
    nbytes = 2 * (2 * b * sq * hq * d + 2 * b * kvl * hkv * d) + 4 * b * hq * sq
    rows.append(_row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:77",
                     launches["flash_attention"], errs_fa[(bf16, 512, 512)],
                     ms, plain_ms, flops, nbytes, lib_ms))

    # K2 at the serve decode shape: 8 slots against the 1024-row cache,
    # at the lengths the served requests reach mid-way through decode.
    b, s = 8, 1024
    kv_len = torch.tensor(np.minimum(serve_lens[:8] + 16, s),
                          dtype=torch.int32, device="cuda")
    sets = [(randn(gen, (b, hq, d), bf16), randn(gen, (b, s, hkv, d), bf16),
             randn(gen, (b, s, hkv, d), bf16)) for _ in range(8)]
    ms = time_ms(lambda q, k, v: da.decode_attention(q, k, v, kv_len), sets)
    plain_ms = time_ms(lambda q, k, v: da.decode_attention_plain(
        q, k, v, kv_len), sets, iters=10)
    mask = (torch.arange(s, device="cuda")[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
    lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                          enable_gqa=True), lib_sets)
    live = int(kv_len.clamp(max=s).sum())
    flops = 4 * d * hq * live
    nbytes = 2 * (2 * live * hkv * d + 2 * b * hq * d) + 4 * b
    rows.append(_row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention/kernel.py:63",
                     launches["decode_attention"], errs_da[bf16], ms,
                     plain_ms, flops, nbytes, lib_ms))
    for r in rows:
        say("6 kernel", **{k: r[k] for k in ("name", "ms", "bound_ms",
                                             "bound_by", "plain_ms",
                                             "library_ms")})
    return rows


def _row(name, source, replaces, launches, err, ms, plain_ms, flops,
         nbytes, lib_ms) -> dict:
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": lib_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    gpu = card()
    for name in KERNELS:                   # build from this checkout's sources
        _build.library_path(name).unlink(missing_ok=True)
    build_s = _build.build(KERNELS)
    say("1 device and build", card=f"'{gpu}'", build_s=f"{build_s:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs_fa = check_flash(fa, gen)
    errs_da = check_decode(da, gen)
    check_reduced_model(get_config, Model, Engine, ServeConfig)
    main_path = serve_full_width(get_config, Model, Engine, ServeConfig,
                                 fa, da)
    rows = kernel_rows(fa, da, gen, main_path["launches"], errs_fa, errs_da,
                       main_path["serve_lens"])
    say("done", total_s=f"{time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
