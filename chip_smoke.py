#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each:

1. device and build: the card's name and power limit, and the time to
   build every kernel of the serve paths from ``src/repro_torch/csrc``;
2. K1 (flash-attention forward) against its plain PyTorch version at the
   prefill shapes of the serve paths (a prefix hit's continuation prefill
   included), in bf16 and f32;
3. K2 (split-K decode) against its plain version with ragged lengths, and
   K3 (paged decode) against its plain version and, bit for bit, against
   K2 on the same rows gathered to a contiguous cache; then the quantized
   kernels, int8 and fp8: K10 (quantized flash forward) and K7 / K8
   (quantized decode, contiguous / paged) against their plain versions,
   and K8 bit for bit against K7 on the gathered rows and scales;
4. a reduced f32 qwen2.5-3b served on the card through the kernels,
   against the same serve on the CPU through the plain versions, with the
   contiguous and with the paged cache, and with an int8 paged cache;
5. full-width qwen2.5-3b in bf16 (random weights from the seed) serving
   16 requests through 8 slots — the main paths: contiguous (K1, K2), and
   paged (K1, K3) with tokens equal to the contiguous run; then a
   shared-prefix run (prefix hits, a hit's logits against a full
   prefill), a page-pressure run (deferred admissions, equal tokens), and
   profiles of a decode tick on each cache; then the quantized paths on
   an int8 cache: contiguous (K10, K7) and paged (K10, K8) with tokens
   equal to the int8 contiguous run, none of K1-K3 launched, an fp8
   contiguous run, an int8 shared-prefix run (K10 with q_offset), a
   profile of an int8 decode tick, and the int8 first-token logits
   against the bf16 cache's (printed, not checked);
6. each kernel's time at its main-path shape beside its bound, its plain
   version's time and one PyTorch library call's time (none computes
   paged attention or attends over a scaled int8 cache: K3's row carries
   K2's time on the gathered rows, K7's, K8's and K10's the time of K2 or
   K1 on the dequantized bf16 rows; K11's library time is the backward of
   one ``scaled_dot_product_attention`` call).

The training path (K11, flash-attention backward, under K1's autograd
Function) adds three phases: 2b, K11 against its plain version in bf16
and f32 at the training shape, a ragged shape and a non-causal Sq < Skv
shape, and the autograd Function's gradients against autograd of the
naive attention; 4b, the reduced f32 qwen2.5-3b trained for 4 steps on
the card against the CPU, then ``repro_torch.launch.train --reduced``
with checkpoints, and a second run resumed from its step-3 checkpoint
against the uninterrupted run; 7, a full-width f32 gradient check (a
small step along the gradient changes the loss by its first-order
prediction), then full-width qwen2.5-3b in bf16 trained for 4 steps
(SyntheticLM batches through PrefetchIterator, 4 x 1024 tokens, 2
microbatches, full remat, the learning rate warmed up over the 4 steps)
with the per-step loss, grad norm, wall ms and tokens/s, peak memory, the
K1 and K11 launch counts and a profile of one step; the loss must fall at
every step.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory without the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
KERNELS = ("flash_attention", "decode_attention")
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate, f32 rate outside the tensor cores, dense int8 / fp8 tensor-core
# rate, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12}
PEAK_BYTES = 3.35e12
QDTYPES = (torch.int8, torch.float8_e4m3fn)
# Kernel-vs-plain tolerances (absolute, inputs ~ N(0, 1)).  f32: the two
# differ only in summation order.  bf16: both round their f32 result to
# bf16 once, so they may differ by one bf16 ulp (2^-7 for |out| < 2).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Reduced model on the card vs on the CPU, f32 logits.
LOGIT_TOL = 1e-4
# Full-width bf16: a prefix hit's first-token logits (continuation prefill
# over the cached pages) against a full prefill of the same prompt, as a
# share of the full prefill's largest |logit|.  The two differ only in
# where bf16 rounds (other matrix shapes, other accumulation orders); phase
# 5 prints beside it the full bf16 prefill's own error against an f32
# prefill of the same weights.
HIT_LOGIT_REL_TOL = 5e-2
PAGE_SIZE = 16
PRESSURE_PAGES = 128     # a quarter of slot parity (8 slots x 64 pages)
# K11 against its plain version: the largest |difference| of each
# gradient over that gradient's largest |value|.  f32: summation order;
# bf16: both round an f32 result to bf16 once (one ulp is 2^-8 of a value).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Reduced f32 training, card against CPU: each step's loss within this
# relative error, and the final params' distance within this share of
# the distance the CPU run moved them.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_RTOL = 1e-3
# Full-width f32 gradient check: the measured loss change of a step
# along the gradient against its first-order prediction, relative.
GRAD_CHECK_RTOL = 5e-2
# Full-width training: 4 steps of 2 microbatches of [2, 1024] tokens.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB = 4, 4, 1024, 2


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
    with kv_len = Sq and q_offset = 0 (the serve prefill), once with the
    defaults (suffix alignment), and Sq = 37 after 256 cached tokens (the
    continuation prefill of a prefix hit: q_offset = 256, kv_len = 293)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(16, 16, 0), (512, 512, 0), (512, None, None),
                 (37, 293, 256)]
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


def paged_inputs(gen, dtype, kv_len, *, scratch_row=None, pages=64,
                 ps=PAGE_SIZE, b=8, hq=16, hkv=2, d=128):
    """K3's main-path shape: B=8, Hq=16, Hkv=2, D=128, ps=16, P=64, a pool
    of 513 pages (page 0 scratch) placed by a seeded permutation;
    ``scratch_row``'s table, if given, is all scratch."""
    n_pool = b * pages + 1
    perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    pt = perm.reshape(b, pages).to(torch.int32)
    if scratch_row is not None:
        pt[scratch_row] = 0
    return (randn(gen, (b, hq, d), dtype),
            randn(gen, (n_pool, ps, hkv, d), dtype),
            randn(gen, (n_pool, ps, hkv, d), dtype), pt.cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


def gathered(k_pool, pt):
    b, pages = pt.shape
    return k_pool[pt.long()].reshape(b, pages * k_pool.shape[1],
                                     *k_pool.shape[2:])


def check_paged_decode(da, gen) -> dict:
    """K3 vs plain with ragged kv_len (row 1 all scratch, one length past
    P * ps), and K3 on the pool == K2 on the gathered cache, bit for bit."""
    kv_len = [1, 100, 1024, 2000, 513, 64, 300, 777]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, pt, kl = paged_inputs(gen, dtype, kv_len, scratch_row=1)
        out = da.paged_decode_attention(q, kp, vp, pt, kl)
        torch.cuda.synchronize()
        err = max_err(out, da.paged_decode_attention_plain(q, kp, vp, pt, kl))
        expect(err <= TOL[dtype], f"K3 {dtype}: err {err}")
        same = torch.equal(out, da.decode_attention(
            q, gathered(kp, pt), gathered(vp, pt), kl))
        expect(same, f"K3 {dtype}: differs from K2 on the gathered cache")
        errs[dtype] = err
    say("3 K3 vs plain", kv_len=kv_len, equal_to_k2_on_gathered=True,
        **{str(d)[6:]: f"{e:.3g}" for d, e in errs.items()})
    return errs


def quantized(quant, x, store):
    return quant.quantize(x, dtype=store, scale_dtype=quant.SCALE_DTYPE)


def gathered_bytes(quant, pool, pt):
    """``gathered`` for any pool dtype (fp8 gathered as bytes)."""
    return gathered(quant.as_bytes(pool), pt).view(pool.dtype)


def check_quantized(fa, da, quant, gen) -> dict:
    """K10, K7 and K8 against their plain versions (bf16 q, int8 and fp8
    K/V quantized from N(0, 1) draws): K10 at the prefill shapes of
    ``check_flash``, K7 and K8 at K2's and K3's ragged lengths, and K8 on
    the pool == K7 on the gathered values and scales, bit for bit."""
    bf16 = torch.bfloat16
    errs = {}
    for store in QDTYPES:
        name = str(store)[6:]
        for sq, kv_len, q_offset in [(16, 16, 0), (512, 512, 0),
                                     (512, None, None), (37, 293, 256)]:
            q = randn(gen, (1, sq, 16, 128), bf16)
            kq, ks = quantized(quant, randn(gen, (1, 1024, 2, 128), bf16),
                               store)
            vq, vs = quantized(quant, randn(gen, (1, 1024, 2, 128), bf16),
                               store)
            out, lse = fa.flash_attention_quantized(
                q, kq, ks, vq, vs, kv_len=kv_len, q_offset=q_offset)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_quantized_plain(
                q, kq, ks, vq, vs, kv_len=kv_len, q_offset=q_offset)
            err = max_err(out, ref)
            expect(err <= TOL[bf16] and max_err(lse, ref_lse) <= 1e-3,
                   f"K10 {name} sq={sq} kv_len={kv_len}: err {err}")
            errs[("k10", store, sq, kv_len)] = err
        kv_len = [1, 100, 1024, 2000, 513, 64, 300, 777]
        q, kp, vp, pt, kl = paged_inputs(gen, bf16, kv_len, scratch_row=1)
        kq, ks = quantized(quant, kp, store)
        vq, vs = quantized(quant, vp, store)
        out = da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl)
        rows = [gathered_bytes(quant, t, pt) for t in (kq, ks, vq, vs)]
        k7 = da.decode_attention_quantized(q, *rows, kl)
        torch.cuda.synchronize()
        err8 = max_err(out, da.paged_decode_attention_quantized_plain(
            q, kq, ks, vq, vs, pt, kl))
        err7 = max_err(k7, da.decode_attention_quantized_plain(q, *rows, kl))
        expect(err7 <= TOL[bf16] and err8 <= TOL[bf16],
               f"K7 / K8 {name}: err {err7} / {err8}")
        expect(torch.equal(out, k7),
               f"K8 {name}: differs from K7 on the gathered cache")
        errs[("k7", store)], errs[("k8", store)] = err7, err8
    say("3 K10 K7 K8 vs plain", k8_equal_to_k7_on_gathered=True,
        **{"_".join(str(p).replace("torch.", "") for p in key): f"{e:.3g}"
           for key, e in errs.items()})
    return errs


def bwd_inputs(fa, gen, dtype, b, sq, skv, hq, hkv, d, causal):
    """q, k, v, do drawn from N(0, 1) and K1's out and lse for them."""
    q, do = randn(gen, (b, sq, hq, d), dtype), randn(gen, (b, sq, hq, d), dtype)
    k, v = randn(gen, (b, skv, hkv, d), dtype), randn(gen, (b, skv, hkv, d),
                                                      dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    return q, k, v, out, lse, do


def check_flash_bwd(fa, naive_attention, gen) -> dict:
    """K11 vs plain in bf16 and f32: the training shape (B=2, S=1024,
    Hq=16, Hkv=2, D=128, causal), a ragged one (S=1000: no multiple of a
    16- or 32-row tile), a non-causal Sq < Skv one; then the autograd
    Function's gradients against autograd of the naive attention (f32)."""
    errs = {}
    cases = {"train": (2, 1024, 1024, 16, 2, 128, True),
             "ragged": (1, 1000, 1000, 16, 2, 128, True),
             "noncausal": (2, 300, 700, 16, 2, 128, False)}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (b, sq, skv, hq, hkv, d, causal) in cases.items():
            ins = bwd_inputs(fa, gen, dtype, b, sq, skv, hq, hkv, d, causal)
            got = fa.flash_attention_bwd(*ins, causal=causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*ins, causal=causal)
            rel = [max_err(g, w) / w.float().abs().max().item()
                   for g, w in zip(got, want)]
            expect(max(rel) <= BWD_TOL[dtype],
                   f"K11 {dtype} {name}: relative errors {rel}")
            errs[(dtype, name)] = {
                "rel": rel, "abs": max(max_err(g, w) for g, w in
                                       zip(got, want))}
            del ins, got, want
    q, k, v = (randn(gen, (1, 256, h, 128), torch.float32)
               for h in (16, 2, 2))
    do = randn(gen, (1, 256, 16, 128), torch.float32)
    grads = []
    for fn in (fa.flash_attention_autograd, naive_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=True).backward(do)
        grads.append([t.grad for t in leaves])
    rel_fn = [max_err(g, w) / w.abs().max().item() for g, w in zip(*grads)]
    expect(max(rel_fn) <= BWD_TOL[torch.float32],
           f"K11 autograd Function vs naive autograd: {rel_fn}")
    say("2b K11 vs plain",
        **{f"{str(dt)[6:]}_{name}_rel_dq_dk_dv":
           "/".join(f"{x:.3g}" for x in e["rel"])
           for (dt, name), e in errs.items()},
        function_vs_naive_rel_dq_dk_dv="/".join(f"{x:.3g}" for x in rel_fn))
    return errs


# ------------------------------------------------------------------ phase 4

def to_device(tree, device):
    """A copy of ``tree`` on ``device`` (the train step updates in place)."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def to_dtype(tree, dtype):
    return {k: to_dtype(v, dtype) if isinstance(v, dict) else v.to(dtype)
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
    # paged: a shared 16-token prefix (hits) and a pool too small for
    # every slot at once (deferrals)
    shared = rng.randint(1, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, p]) for p in prompts]
    pcfg = ServeConfig(max_len=80, slots=4, refill_schedule="faa",
                       cache="paged", page_size=8, num_pages=20)
    cpu_eng, gpu_eng = Engine(cpu, params_cpu, pcfg), Engine(gpu, params_gpu,
                                                              pcfg)
    out_cpu, out_gpu = cpu_eng.serve(prompts, 12), gpu_eng.serve(prompts, 12)
    same = all(np.array_equal(a, b) for a, b in zip(out_cpu, out_gpu))
    rep, want = gpu_eng.last_report, cpu_eng.last_report
    expect(same and rep.prefix_hits == want.prefix_hits > 0
           and rep.deferred_admissions == want.deferred_admissions > 0,
           "reduced paged serve: card differs from the plain path")
    say("4 reduced f32 paged serve", requests=len(prompts), tokens_equal=same,
        prefix_hits=rep.prefix_hits,
        deferred_admissions=rep.deferred_admissions)
    # the same on an int8 cache: K10 and K8 on the card, their plain
    # versions on the CPU
    qcfg = dataclasses.replace(pcfg, kv_dtype="int8")
    cpu_eng, gpu_eng = Engine(cpu, params_cpu, qcfg), Engine(gpu, params_gpu,
                                                              qcfg)
    out_cpu, out_gpu = cpu_eng.serve(prompts, 12), gpu_eng.serve(prompts, 12)
    same = all(np.array_equal(a, b) for a, b in zip(out_cpu, out_gpu))
    rep, want = gpu_eng.last_report, cpu_eng.last_report
    expect(same and rep.prefix_hits == want.prefix_hits > 0
           and rep.deferred_admissions == want.deferred_admissions > 0,
           "reduced int8 paged serve: card differs from the plain path")
    say("4 reduced f32 int8-KV paged serve", requests=len(prompts),
        tokens_equal=same, prefix_hits=rep.prefix_hits,
        deferred_admissions=rep.deferred_admissions)


def tree_dist(a, b) -> float:
    total = 0.0
    for key in a:
        if isinstance(a[key], dict):
            total += tree_dist(a[key], b[key]) ** 2
        else:
            total += (a[key].float() - b[key].float()).pow(2).sum().item()
    return total ** 0.5


def check_reduced_training(get_config, Model, opt, make_train_step,
                           DataConfig, SyntheticLM, launch_train, fa) -> None:
    """The reduced f32 qwen2.5-3b: 4 steps of ``make_train_step``
    (microbatches 2) on SyntheticLM batches, on the card against the CPU;
    then the launcher for 6 steps, and a second run resumed from its
    step-3 checkpoint (steps 4-6: equal loss histories)."""
    cfg = get_config("qwen2.5-3b").reduced()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4, host_threads=2))
    init = Model(cfg, device="cpu").init(SEED)
    runs = {}
    for device in ("cpu", "cuda"):
        params = to_device(init, device)
        state = opt.init_state(params, ocfg)
        step = make_train_step(Model(cfg, device=device), ocfg,
                               microbatches=2)
        before = fa.flash_attention_bwd.launches
        losses = []
        for i in range(4):
            toks = torch.as_tensor(data.batch(i)["tokens"], device=device)
            params, state, met = step(params, state, {"tokens": toks})
            losses.append(met["loss"].item())
        runs[device] = (losses, to_device(params, "cpu"),
                        fa.flash_attention_bwd.launches - before)
    (cpu_loss, cpu_p, _), (card_loss, card_p, k11) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    param_err = tree_dist(card_p, cpu_p) / tree_dist(cpu_p, init)
    expect(loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_RTOL
           and k11 == 4 * 2 * cfg.n_layers,
           f"reduced training: loss err {loss_err}, param err {param_err}, "
           f"K11 launches {k11}")
    say("4b reduced f32 train card vs cpu", steps=4, microbatches=2,
        losses="/".join(f"{x:.6f}" for x in card_loss),
        loss_rel_err=f"{loss_err:.3g}", param_rel_err=f"{param_err:.3g}",
        launches_flash_bwd=k11)
    # the launcher for 6 steps (checkpoints at 3 and 6), then again from
    # a copy of its checkpoints without step 6: it resumes at step 3
    root = Path(__file__).resolve().parent / "build" / "smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "6", "--batch",
            "4", "--seq", "64", "--microbatches", "2", "--ckpt-every", "3",
            "--log-every", "1", "--device", "cuda"]
    full = launch_train.main(args + ["--ckpt-dir", str(root / "full")])
    shutil.copytree(root / "full", root / "cut")
    shutil.rmtree(root / "cut" / "step_00000006")
    resumed = launch_train.main(args + ["--ckpt-dir", str(root / "cut")])
    same = resumed["history"] == full["history"][3:]
    expect(same and resumed["final_step"] == 6,
           f"resumed training differs: {resumed['history']} vs "
           f"{full['history']}")
    shutil.rmtree(root, ignore_errors=True)
    say("4b launch.train --reduced resumed", history_equal=same,
        losses="/".join(f"{x:.6f}" for _, x in full["history"]))


# ------------------------------------------------------------------ phase 5

def _category(kernel: str) -> str:
    name = kernel.lower()
    # the template arguments name the K/V storage type of a quantized kernel
    tmpl = name.replace("(anonymous namespace)", "").split("(")[0]
    quant = any(t in tmpl for t in ("signed char", "fp8"))
    if "fa_fwd_kernel" in name:
        return "k10" if quant else "k1"
    if "fa_bwd_" in name:
        return "k11"      # dq, dk/dv and the GQA group sum
    if "decode_split_kernel" in name:
        if "pagedrows" in name:
            return "k8" if quant else "k3"
        return "k7" if quant else "k2"
    if "decode_combine_kernel" in name:
        return "combine"    # the second launch of K2, K3, K7 and K8
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def profile(fn, iters: int, top: int = 0) -> dict:
    """``fn`` timed on the host clock without a profiler (``wall_ms``),
    then one call under torch.profiler: the device time of its kernels by
    category (K1, K10 and K11, the split kernels of K2, K3, K7 and K8,
    their shared combine kernel, matrix products, all other kernels; a
    category with no kernel is left out), their number, the device's idle
    share of the unprofiled wall time, and with ``top`` the names (cut to
    40 characters) and ms of the ``top`` largest kernels of "other"."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wall = wall_ms(fn, iters)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(("k1", "k10", "k11", "k2", "k3", "k7", "k8",
                        "combine", "matmul", "other"), 0.0)
    kernels = 0
    other: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            cat = _category(ev.name)
            ms[cat] += ev.device_time_total / 1e3
            kernels += 1
            if cat == "other":
                name = ev.name[:40].replace(" ", "")
                other[name] = other.get(name, 0.0) + ev.device_time_total / 1e3
    busy = sum(ms.values())
    if busy == 0:
        return {"wall_ms": f"{wall:.2f}", "device_ms": "not measured"}
    largest = sorted(other.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": f"{wall:.2f}", "device_ms": f"{busy:.2f}",
            "idle_share": f"{max(0.0, 1 - busy / wall):.3f}",
            "kernels": kernels,
            **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items() if v > 0},
            **({"other_largest": ";".join(f"{n}={v:.1f}" for n, v in largest)}
               if largest else {})}


def wrappers(fa, da) -> dict:
    """Every kernel wrapper of the serve and training paths by name (each
    counts its launches)."""
    return {fn.__name__: fn for fn in (
        fa.flash_attention, da.decode_attention, da.paged_decode_attention,
        fa.flash_attention_quantized, da.decode_attention_quantized,
        da.paged_decode_attention_quantized, fa.flash_attention_bwd)}


def reset_counts(fa, da) -> None:
    for fn in wrappers(fa, da).values():
        fn.launches = 0


def read_counts(fa, da) -> dict:
    return {name: fn.launches for name, fn in wrappers(fa, da).items()}


def launched_only(launches: dict, names) -> bool:
    """Every kernel in ``names`` was launched and no other."""
    return all((n > 0) == (name in names) for name, n in launches.items())


def drive(eng, prompts, fa, da, n_new: int = 32):
    """One serve() with every launch count set to 0 just before it and
    read just after; returns (outputs, counts)."""
    torch.cuda.synchronize()
    reset_counts(fa, da)
    outs = eng.serve(prompts, n_new)
    torch.cuda.synchronize()
    return outs, read_counts(fa, da)


def same_tokens(a, b) -> list:
    return [bool(np.array_equal(x, y)) for x, y in zip(a, b)]


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
    base = dict(max_len=1024, slots=8, refill_schedule="faa",
                cache_dtype="bfloat16")
    eng = Engine(model, params, ServeConfig(**base))
    eng.serve(prompts[:2], 2)                     # warm-up (cuBLAS, caches)
    outs, launches = drive(eng, prompts, fa, da)  # main path: contiguous
    rep = eng.last_report
    expect(launched_only(launches, ("flash_attention", "decode_attention")),
           f"contiguous main path: launches {launches}")
    expect(len(outs) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs), "full-width serve: malformed outputs")
    # per-phase times, outside the counted runs: one 512-wide prefill and
    # one decode tick of the 8-slot batch (each ends in a host sync)
    toks = np.zeros((1, 512), np.int32)
    toks[0] = rng.randint(0, cfg.vocab_size, 512)

    def prefill():
        return eng._prefill_padded(params, toks, np.array([512], np.int32))

    logits, _ = prefill()
    expect(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    tick = np.zeros((8, 1), np.int32)
    tick_cache = eng._backend.cache
    decode = profile(lambda: model.decode_step(params, tick, tick_cache), 10)
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

    # main path: paged, prefix cache off — the contiguous run's tokens bit
    # for bit, every decode tick through K3 and none through K2
    paged = dict(base, cache="paged", page_size=PAGE_SIZE)
    eng_p = Engine(model, params, ServeConfig(**paged, prefix_cache=False))
    eng_p.serve(prompts[:2], 2)                   # warm-up
    outs_p, launches_p = drive(eng_p, prompts, fa, da)
    rep_p = eng_p.last_report
    expect(all(same_tokens(outs, outs_p)),
           "full-width paged serve: tokens differ from the contiguous run")
    expect(launched_only(launches_p, ("flash_attention",
                                      "paged_decode_attention")),
           f"full-width paged serve: launches {launches_p}")
    say("5 full-width bf16 paged serve", tokens_equal_contiguous=True,
        tokens=rep_p.total_tokens, ticks=rep_p.total_ticks,
        wall_s=f"{rep_p.wall_s:.3f}",
        tokens_per_s=f"{rep_p.total_tokens / rep_p.wall_s:.1f}",
        pages_allocated=rep_p.pages_allocated,
        peak_pages_live=rep_p.peak_pages_live,
        launches_flash=launches_p["flash_attention"],
        launches_paged_decode=launches_p["paged_decode_attention"],
        launches_decode=launches_p["decode_attention"])
    # the paged tick at the contiguous tick's lengths: slot s owns pool
    # pages 64 s + 1 .. 64 s + 64 (the tick writes garbage into them)
    pool = eng_p._backend.cache
    n_layers = pool["pt"].shape[0]
    table = torch.arange(1, 513, dtype=torch.int32, device="cuda").reshape(
        8, 64).expand(n_layers, 8, 64).contiguous()
    paged_tick = {"k": pool["k"], "v": pool["v"], "pt": table,
                  "len": tick_cache["len"].clone()}
    decode_p = profile(lambda: model.decode_step(params, tick, paged_tick), 10)
    say("5 profile paged decode tick (8 slots)", **decode_p)
    del eng_p, pool, paged_tick

    prefix = check_prefix_run(cfg, model, params, eng, Engine, ServeConfig,
                              paged, fa, da)

    # page pressure: a quarter of slot parity defers admissions, and the
    # tokens stay the contiguous run's
    eng_q = Engine(model, params, ServeConfig(
        **paged, prefix_cache=False, num_pages=PRESSURE_PAGES))
    outs_q, launches_q = drive(eng_q, prompts, fa, da)
    rep_q = eng_q.last_report
    expect(rep_q.deferred_admissions > 0,
           "page-pressure run: no admission was deferred")
    expect(all(same_tokens(outs, outs_q)),
           "page-pressure run: tokens differ from the contiguous run")
    say("5 full-width bf16 page pressure", num_pages=PRESSURE_PAGES,
        deferred_admissions=rep_q.deferred_admissions,
        peak_pages_live=rep_q.peak_pages_live, ticks=rep_q.total_ticks,
        contiguous_ticks=rep.total_ticks, tokens_equal_contiguous=True,
        wall_s=f"{rep_q.wall_s:.3f}",
        launches_paged_decode=launches_q["paged_decode_attention"])
    del eng_q
    quant_path = serve_quantized(
        cfg, model, params, Engine, ServeConfig, base, paged, prompts, outs,
        lambda: model.decode_step(params, tick, tick_cache), fa, da)
    del params, eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_paged": launches_p,
            "serve_lens": lens, "prefix": prefix, **quant_path}


def serve_quantized(cfg, model, params, Engine, ServeConfig, base, paged,
                    prompts, outs_bf16, bf16_tick, fa, da) -> dict:
    """The quantized paths at full width, on the contiguous run's requests:
    int8 contiguous (K10, K7), int8 paged with the prefix cache off (K10,
    K8; tokens equal to int8 contiguous), fp8 contiguous, and an int8
    shared-prefix run; none of them launches K1, K2 or K3.  ``bf16_tick``
    runs one decode tick of the bf16 contiguous run, timed in turns with
    the int8 tick."""
    q8 = dict(base, kv_dtype="int8")
    eng_c = Engine(model, params, ServeConfig(**q8))
    eng_c.serve(prompts[:2], 2)                   # warm-up
    outs_c, launches_c = drive(eng_c, prompts, fa, da)
    rep_c = eng_c.last_report
    expect(launched_only(launches_c, ("flash_attention_quantized",
                                      "decode_attention_quantized")),
           f"int8 contiguous serve: launches {launches_c}")
    expect(len(outs_c) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs_c), "int8 contiguous serve: malformed outputs")
    say("5 full-width int8-KV serve", tokens=rep_c.total_tokens,
        ticks=rep_c.total_ticks, wall_s=f"{rep_c.wall_s:.3f}",
        tokens_per_s=f"{rep_c.total_tokens / rep_c.wall_s:.1f}",
        launches_flash_quantized=launches_c["flash_attention_quantized"],
        launches_decode_quantized=launches_c["decode_attention_quantized"],
        share_equal_bf16=f"{np.mean(same_tokens(outs_bf16, outs_c)):.3f}")
    tick = np.zeros((8, 1), np.int32)
    tick_cache = eng_c._backend.cache
    def int8_tick():
        return model.decode_step(params, tick, tick_cache)

    decode = profile(int8_tick, 10)
    say("5 profile int8-KV decode tick (8 slots)", **decode)
    # host time of the two ticks in turns (bf16, int8, int8, bf16): the
    # host's drift between phases is larger than their difference
    turns = [wall_ms(fn, 10) for fn in (bf16_tick, int8_tick, int8_tick,
                                        bf16_tick)]
    say("5 decode tick wall ms in turns", bf16_a=f"{turns[0]:.2f}",
        int8_a=f"{turns[1]:.2f}", int8_b=f"{turns[2]:.2f}",
        bf16_b=f"{turns[3]:.2f}")

    eng_p = Engine(model, params, ServeConfig(**dict(paged, kv_dtype="int8"),
                                              prefix_cache=False))
    eng_p.serve(prompts[:2], 2)                   # warm-up
    outs_p, launches_p = drive(eng_p, prompts, fa, da)
    rep_p = eng_p.last_report
    expect(all(same_tokens(outs_c, outs_p)),
           "int8 paged serve: tokens differ from the int8 contiguous run")
    expect(launched_only(launches_p, ("flash_attention_quantized",
                                      "paged_decode_attention_quantized")),
           f"int8 paged serve: launches {launches_p}")
    say("5 full-width int8-KV paged serve", tokens_equal_contiguous=True,
        tokens=rep_p.total_tokens, ticks=rep_p.total_ticks,
        wall_s=f"{rep_p.wall_s:.3f}",
        tokens_per_s=f"{rep_p.total_tokens / rep_p.wall_s:.1f}",
        launches_flash_quantized=launches_p["flash_attention_quantized"],
        launches_paged_decode_quantized=launches_p[
            "paged_decode_attention_quantized"])
    del eng_p

    eng_f = Engine(model, params,
                   ServeConfig(**dict(base, kv_dtype="float8_e4m3fn")))
    outs_f, launches_f = drive(eng_f, prompts, fa, da)
    rep_f = eng_f.last_report
    expect(launched_only(launches_f, ("flash_attention_quantized",
                                      "decode_attention_quantized")),
           f"fp8 contiguous serve: launches {launches_f}")
    expect(all(o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
               for o in outs_f), "fp8 contiguous serve: malformed outputs")
    say("5 full-width fp8-KV serve", tokens=rep_f.total_tokens,
        ticks=rep_f.total_ticks, wall_s=f"{rep_f.wall_s:.3f}",
        tokens_per_s=f"{rep_f.total_tokens / rep_f.wall_s:.1f}",
        share_equal_int8=f"{np.mean(same_tokens(outs_c, outs_f)):.3f}",
        launches_flash_quantized=launches_f["flash_attention_quantized"],
        launches_decode_quantized=launches_f["decode_attention_quantized"])
    del eng_f

    # int8 shared prefix: every hit's continuation prefill runs K10 with
    # q_offset = 256 over the cached int8 pages
    rng = np.random.RandomState(SEED + 1)
    shared = rng.randint(0, cfg.vocab_size, 256).astype(np.int32)
    shared_prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size,
                                                          n)]).astype(np.int32)
                      for n in rng.randint(16, 257, 16)]
    eng_x = Engine(model, params, ServeConfig(**dict(paged, kv_dtype="int8"),
                                              prefix_cache=True))
    _, launches_x = drive(eng_x, shared_prompts, fa, da)
    rep_x = eng_x.last_report
    expect(rep_x.prefix_hits >= 14
           and rep_x.prefix_hit_tokens == 256 * rep_x.prefix_hits
           and all(t.prefill_tokens + t.prefix_hit_tokens == t.prompt_len
                   for t in rep_x.requests),
           f"int8 prefix run: {rep_x.prefix_hits} hits, "
           f"{rep_x.prefix_hit_tokens} hit tokens")
    expect(launched_only(launches_x, ("flash_attention_quantized",
                                      "paged_decode_attention_quantized")),
           f"int8 prefix run: launches {launches_x}")
    say("5 full-width int8-KV shared prefix", prefix_hits=rep_x.prefix_hits,
        prefix_hit_tokens=rep_x.prefix_hit_tokens,
        prefill_tokens=rep_x.prefill_tokens, wall_s=f"{rep_x.wall_s:.3f}",
        launches_flash_quantized=launches_x["flash_attention_quantized"])
    del eng_x

    # for information: an int8 cache's first-token logits against a bf16
    # cache's, same weights, same 512-token prompt
    toks = np.zeros((1, 512), np.int32)
    toks[0] = np.random.RandomState(SEED + 2).randint(0, cfg.vocab_size, 512)
    batch = {"tokens": toks, "lengths": np.array([512], np.int32)}
    wide, _ = model.prefill_padded(params, batch, 1024, torch.bfloat16)
    narrow, _ = model.prefill_padded(params, batch, 1024, torch.int8)
    scale = wide.abs().max().item()
    say("5 int8-KV vs bf16-KV first-token logits",
        max_abs_err=f"{max_err(narrow, wide):.3g}",
        max_abs_logit=f"{scale:.3g}",
        rel_err=f"{max_err(narrow, wide) / scale:.3g}",
        argmax_equal=bool(narrow.argmax() == wide.argmax()))
    del eng_c, tick_cache
    torch.cuda.empty_cache()
    return {"launches_int8": launches_c, "launches_int8_paged": launches_p}


def check_prefix_run(cfg, model, params, eng, Engine, ServeConfig, paged,
                     fa, da) -> dict:
    """16 requests sharing a 256-token prefix, each with a unique suffix of
    16-256 tokens, 32 new tokens each, prefix cache on."""
    rng = np.random.RandomState(SEED + 1)
    shared = rng.randint(0, cfg.vocab_size, 256).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, n)])
               .astype(np.int32) for n in rng.randint(16, 257, 16)]
    eng_x = Engine(model, params, ServeConfig(**paged, prefix_cache=True))
    outs, launches = drive(eng_x, prompts, fa, da)
    rep = eng_x.last_report
    expect(rep.prefix_hits >= 14, f"prefix run: {rep.prefix_hits} hits")
    expect(rep.prefix_hit_tokens == 256 * rep.prefix_hits,
           f"prefix run: {rep.prefix_hit_tokens} hit tokens for "
           f"{rep.prefix_hits} hits")
    expect(all(t.prefill_tokens + t.prefix_hit_tokens == t.prompt_len
               for t in rep.requests), "prefix run: recomputed tokens")
    # one hit admission's first-token logits (the continuation prefill
    # over the cached pages, recomputed as admit() computes them) against
    # full prefills of the same prompt at its bucket width and unpadded
    backend = eng_x._backend
    prompt = prompts[1]
    # the trie also holds this prompt's own suffix pages: keep the prefix
    matched = backend.prefix.match(prompt)[:16]
    pt_row = np.zeros(backend.pages_per_seq, np.int32)
    pt_row[: len(matched)] = matched
    view = model.gather_prefix_cache(backend.cache, pt_row, 256,
                                     spec=backend.spec, page_size=PAGE_SIZE)
    hit, _ = model.prefill_continue(params, prompt[256:][None, :], view)
    width = eng._bucket_width(len(prompt))
    toks = np.zeros((1, width), np.int32)
    toks[0, : len(prompt)] = prompt
    batch = {"tokens": toks, "lengths": np.array([len(prompt)], np.int32)}
    full, _ = model.prefill_padded(params, batch, 1024, eng.kv_dtype)
    # bf16's own error: the same prefill with the same weights in f32
    model32 = type(model)(cfg.with_dtype("float32"), device=model.device)
    params32 = to_dtype(params, torch.float32)
    exact, _ = model32.prefill_padded(params32, batch, 1024, torch.float32)
    del model32, params32
    torch.cuda.empty_cache()
    scale = full.abs().max().item()
    err = max_err(hit, full) / scale
    floor = max_err(full, exact) / scale
    expect(len(matched) == 16 and err <= HIT_LOGIT_REL_TOL,
           f"prefix hit logits: relative error {err} (bf16 vs f32 {floor})")
    contiguous = eng.serve(prompts, 32)
    equal = same_tokens(contiguous, outs)
    result = dict(prefix_hits=rep.prefix_hits,
                  prefix_hit_tokens=rep.prefix_hit_tokens,
                  prefill_tokens=rep.prefill_tokens,
                  hit_logit_rel_err=f"{err:.3g}",
                  bf16_vs_f32_rel_err=f"{floor:.3g}",
                  hit_argmax_equal=bool(hit.argmax() == full.argmax()),
                  max_abs_logit=f"{scale:.3g}",
                  share_equal_contiguous=f"{sum(equal) / len(equal):.3f}",
                  wall_s=f"{rep.wall_s:.3f}",
                  launches_paged_decode=launches["paged_decode_attention"])
    say("5 full-width bf16 shared prefix", **result)
    return result


# ------------------------------------------------------------------ phase 7

def check_full_width_gradient(get_config, Model, DataConfig, SyntheticLM,
                              fa) -> dict:
    """Full-width qwen2.5-3b in f32: the gradient of ``Model.loss`` (one
    [1, 1024] SyntheticLM row, full remat, every attention backward
    through K11) predicts the loss change of a small step along it.  For
    a step -eta * d, with d the gradient restricted to some leaves, the
    loss must change by -eta * |d|^2 to first order; eta is chosen so that
    the change is 0.01.  Two directions: every leaf, and the q, k and v
    projections alone (whose gradients reach them only through K11)."""
    gc.collect()            # the serve phases' engines may sit in cycles
    cfg = get_config("qwen2.5-3b")
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    toks = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=1,
                                  seed=SEED)).batch(0)["tokens"]
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    names, leaves = [], []

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], prefix + key + "/")
            else:
                names.append(prefix + key)
                leaves.append(node[key].requires_grad_())

    walk(params, "")
    before = fa.flash_attention_bwd.launches
    loss0, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss0, leaves)
    k11 = fa.flash_attention_bwd.launches - before
    for t in leaves:
        t.requires_grad_(False)
    result = {"loss": f"{loss0.item():.6f}", "launches_flash_bwd": k11}
    for label, keep in (("all", lambda n: True),
                        ("qkv", lambda n: n.startswith(
                            ("blocks/attn/wq/", "blocks/attn/wk/",
                             "blocks/attn/wv/")))):
        sq = sum(g.double().pow(2).sum().item()
                 for n, g in zip(names, grads) if keep(n))
        eta = 1e-2 / sq
        with torch.no_grad():
            for n, t, g in zip(names, leaves, grads):
                if keep(n):
                    t.sub_(g, alpha=eta)
            loss1, _ = model.loss(params, batch)
            for n, t, g in zip(names, leaves, grads):
                if keep(n):
                    t.add_(g, alpha=eta)
        change = loss1.item() - loss0.item()
        rel = abs(change + 1e-2) / 1e-2
        expect(rel <= GRAD_CHECK_RTOL,
               f"full-width gradient ({label}): loss change {change}, "
               f"first order -0.01")
        result[f"{label}_loss_change"] = f"{change:.6g}"
        result[f"{label}_rel_err"] = f"{rel:.3g}"
    expect(k11 == cfg.n_layers, f"gradient check: {k11} K11 launches")
    say("7 full-width f32 gradient check", **result)
    del params, leaves, grads, loss0
    torch.cuda.empty_cache()
    return result


def train_full_width(get_config, Model, opt, make_train_step, DataConfig,
                     SyntheticLM, PrefetchIterator, fa, da) -> dict:
    """Full-width qwen2.5-3b in bf16 (weights from the seed), the training
    main path: 4 steps of ``make_train_step`` with 2 microbatches on
    SyntheticLM batches of 4 x 1024 tokens through PrefetchIterator, full
    remat; every attention forward is K1 (twice per layer and microbatch)
    and every attention backward K11.  Then one more step profiled."""
    cfg = get_config("qwen2.5-3b").with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    # From the random init, Adam's first steps move every weight by about
    # the lr whatever its gradient; at the default lr (3e-4) with one
    # warmup step they overshoot and the loss rises again from step 3.  A
    # smaller lr warmed up over the steps trains steadily.
    ocfg = opt.AdamWConfig(lr=3e-5, warmup_steps=TRAIN_STEPS)
    params = model.init(SEED)
    state = opt.init_state(params, ocfg)
    step = make_train_step(model, ocfg, microbatches=TRAIN_MB)
    data = PrefetchIterator(
        SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=SEED)),
        start_step=0, num_steps=TRAIN_STEPS + 3)
    batches = ({"tokens": torch.as_tensor(b["tokens"], device="cuda")}
               for _, b in data)
    gc.collect()            # earlier phases' engines may sit in cycles
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, da)
    losses, tokens = [], TRAIN_BATCH * TRAIN_SEQ
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        loss = met["loss"].item()          # ends in a device sync
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        say(f"7 full-width bf16 train step {i + 1}", loss=f"{loss:.4f}",
            grad_norm=f"{met['grad_norm'].item():.4g}", wall_ms=f"{ms:.1f}",
            tokens_per_s=f"{tokens / ms * 1e3:.1f}")
    torch.cuda.synchronize()
    launches = read_counts(fa, da)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_MB * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_MB * TRAIN_STEPS}
    expect(all(np.isfinite(losses))
           and all(b < a for a, b in zip(losses, losses[1:])),
           f"full-width training: the loss must fall at every step, "
           f"losses {losses}")
    expect(launches == {name: want.get(name, 0) for name in launches},
           f"full-width training: launches {launches}, want {want}")
    prof = profile(lambda: step(params, state, next(batches)), 1, top=8)
    data.close()
    result = dict(steps=TRAIN_STEPS, tokens_per_step=tokens,
                  microbatches=TRAIN_MB,
                  losses="/".join(f"{x:.4f}" for x in losses),
                  peak_memory_gb=f"{peak_gb:.2f}",
                  memory_at_start_gb=f"{base_gb:.2f}",
                  launches_flash=launches["flash_attention"],
                  launches_flash_bwd=launches["flash_attention_bwd"])
    say("7 full-width bf16 train", **result)
    say("7 profile train step", **prof)
    del params, state, step, model
    torch.cuda.empty_cache()
    return {"launches_train": launches}


# ------------------------------------------------------------------ phase 6

def kernel_rows(fa, da, gen, main_path, errs_fa, errs_da, errs_pa) -> list:
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launches = main_path["launches"]
    serve_lens = main_path["serve_lens"]
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
    del sets, lib_sets

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
    del sets, lib_sets

    # K3 at the paged decode shape: the same 8 rows and lengths read from a
    # 513-page pool through a seeded page placement; beside it, K2 on the
    # same rows gathered to a contiguous cache (the page indirection's cost)
    sets = [paged_inputs(gen, bf16, kv_len.tolist()) for _ in range(8)]
    ms = time_ms(lambda q, kp, vp, pt, kl: da.paged_decode_attention(
        q, kp, vp, pt, kl), sets)
    plain_ms = time_ms(lambda q, kp, vp, pt, kl:
                       da.paged_decode_attention_plain(q, kp, vp, pt, kl),
                       sets, iters=10)
    gathered_sets = [(q, gathered(kp, pt), gathered(vp, pt), kl)
                     for q, kp, vp, pt, kl in sets]
    k2_ms = time_ms(lambda q, k, v, kl: da.decode_attention(q, k, v, kl),
                    gathered_sets)
    pages_read = int(((kv_len.clamp(max=s) + PAGE_SIZE - 1)
                      // PAGE_SIZE).sum())
    nbytes = (2 * (2 * live * hkv * d + 2 * b * hq * d) + 4 * b
              + 4 * pages_read)
    row = _row("paged_decode_attention",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:422",
               main_path["launches_paged"]["paged_decode_attention"],
               errs_pa[bf16], ms, plain_ms, flops, nbytes, None)
    row["k2_gathered_ms"] = k2_ms
    rows.append(row)
    return rows


def bwd_kernel_row(fa, gen, main_path, errs_bwd) -> dict:
    """K11 at the training shape: B=2, S=1024, Hq=16, Hkv=2, D=128, causal,
    bf16.  Beside it, K1's forward at the same shape, and the library's
    backward of one ``scaled_dot_product_attention`` call (K and V
    expanded to the 16 query heads, as K11's per-head partials are)."""
    bf16 = torch.bfloat16
    b, s, hq, hkv, d = 2, 1024, 16, 2, 128
    sets = [bwd_inputs(fa, gen, bf16, b, s, s, hq, hkv, d, True)
            for _ in range(4)]                 # 4 x 26 MB, past the L2
    ms = time_ms(lambda *a: fa.flash_attention_bwd(*a, causal=True), sets,
                 iters=10)
    plain_ms = time_ms(lambda *a: fa.flash_attention_bwd_plain(
        *a, causal=True), sets, iters=3)
    k1_ms = time_ms(lambda q, k, v, *_: fa.flash_attention(q, k, v), sets,
                    iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = []
    for q, k, v, _, _, do in sets:
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (
            q, k.repeat_interleave(hq // hkv, 2),
            v.repeat_interleave(hq // hkv, 2))]
        out = sdpa(*leaves, is_causal=True)
        lib_sets.append((out, leaves, do.transpose(1, 2)))
    lib_ms = time_ms(lambda out, leaves, do: torch.autograd.grad(
        out, leaves, do, retain_graph=True), lib_sets, iters=10)
    del lib_sets
    pairs = s * (s + 1) // 2
    flops = 5 * 2 * d * hq * b * pairs          # s, dp, dv, dk, dq
    nbytes = (2 * (4 * b * s * hq * d + 4 * b * s * hkv * d)
              + 4 * b * hq * s)                  # q out do dq, k v dk dv, lse
    row = _row("flash_attention_bwd", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:528",
               main_path["launches_train"]["flash_attention_bwd"],
               errs_bwd[(bf16, "train")]["abs"], ms, plain_ms, flops, nbytes,
               lib_ms)
    row["max_rel_err"] = max(errs_bwd[(bf16, "train")]["rel"])
    row["k1_same_shape_ms"] = k1_ms
    return row


def quant_kernel_rows(fa, da, quant, gen, main_path, errs_q) -> list:
    """K10, K7 and K8 on an int8 cache at K1's, K2's and K3's main-path
    shapes and lengths.  No single PyTorch call attends over a scaled int8
    cache; beside each kernel stands its float twin (K1 or K2) on the same
    rows dequantized to bf16, and beside K8 also K7 on the gathered rows."""
    bf16, i8 = torch.bfloat16, torch.int8
    rows = []

    def dequantized(xq, xs):
        return quant.dequantize(xq, xs).to(bf16)

    # K10 at the serve prefill shape: a 512-token prompt against the
    # 1024-row int8 cache, kv_len = 512, q_offset = 0
    b, sq, skv, hq, hkv, d, kvl = 1, 512, 1024, 16, 2, 128, 512
    sets = []
    for _ in range(16):
        q = randn(gen, (b, sq, hq, d), bf16)
        kq, ks = quantized(quant, randn(gen, (b, skv, hkv, d), bf16), i8)
        vq, vs = quantized(quant, randn(gen, (b, skv, hkv, d), bf16), i8)
        sets.append((q, kq, ks, vq, vs))
    ms = time_ms(lambda *a: fa.flash_attention_quantized(
        *a, kv_len=kvl, q_offset=0), sets)
    plain_ms = time_ms(lambda *a: fa.flash_attention_quantized_plain(
        *a, kv_len=kvl, q_offset=0), sets, iters=5)
    deq_sets = [(q, dequantized(kq, ks), dequantized(vq, vs))
                for q, kq, ks, vq, vs in sets]
    k1_ms = time_ms(lambda q, k, v: fa.flash_attention(
        q, k, v, kv_len=kvl, q_offset=0), deq_sets)
    pairs = sum(min(i + 1, kvl) for i in range(sq))
    flops = 4 * d * hq * b * pairs
    nbytes = (2 * 2 * b * sq * hq * d + 2 * b * kvl * hkv * (d + 2)
              + 4 * b * hq * sq)
    row = _row("flash_attention_quantized",
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:373",
               main_path["launches_int8"]["flash_attention_quantized"],
               errs_q[("k10", i8, 512, 512)], ms, plain_ms, flops, nbytes,
               None, ops_dtype=i8)
    row["k1_dequantized_ms"] = k1_ms
    rows.append(row)
    del sets, deq_sets

    # K7 at the serve decode shape: 8 slots against the 1024-row int8
    # cache at K2's lengths; 16 input sets, 64 MB as K2's 8 bf16 sets
    b, s = 8, 1024
    kv_len = torch.tensor(np.minimum(main_path["serve_lens"][:8] + 16, s),
                          dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(16):
        kq, ks = quantized(quant, randn(gen, (b, s, hkv, d), bf16), i8)
        vq, vs = quantized(quant, randn(gen, (b, s, hkv, d), bf16), i8)
        sets.append((randn(gen, (b, hq, d), bf16), kq, ks, vq, vs, kv_len))
    ms = time_ms(da.decode_attention_quantized, sets)
    plain_ms = time_ms(da.decode_attention_quantized_plain, sets, iters=10)
    # K2 on 8 dequantized sets: 64 MB of bf16 rows, K2's own row's
    # footprint (both exceed the 50 MB L2 by as much)
    deq_sets = [(q, dequantized(kq, ks), dequantized(vq, vs), kl)
                for q, kq, ks, vq, vs, kl in sets[:8]]
    k2_ms = time_ms(da.decode_attention, deq_sets)
    live = int(kv_len.clamp(max=s).sum())
    flops = 4 * d * hq * live
    nbytes = 2 * live * hkv * (d + 2) + 2 * 2 * b * hq * d + 4 * b
    row = _row("decode_attention_quantized",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:316",
               main_path["launches_int8"]["decode_attention_quantized"],
               errs_q[("k7", i8)], ms, plain_ms, flops, nbytes, None,
               ops_dtype=i8)
    row["k2_dequantized_ms"] = k2_ms
    rows.append(row)
    del sets, deq_sets

    # K8 at the paged decode shape: the same rows and lengths from a
    # 513-page int8 pool through a seeded page placement
    sets = []
    for _ in range(16):
        q, kp, vp, pt, kl = paged_inputs(gen, bf16, kv_len.tolist())
        kq, ks = quantized(quant, kp, i8)
        vq, vs = quantized(quant, vp, i8)
        sets.append((q, kq, ks, vq, vs, pt, kl))
        del kp, vp
    ms = time_ms(da.paged_decode_attention_quantized, sets)
    plain_ms = time_ms(da.paged_decode_attention_quantized_plain, sets,
                       iters=10)
    gathered_sets = [(q, *(gathered_bytes(quant, t, pt)
                           for t in (kq, ks, vq, vs)), kl)
                     for q, kq, ks, vq, vs, pt, kl in sets]
    k7_ms = time_ms(da.decode_attention_quantized, gathered_sets)
    deq_sets = [(q, dequantized(kq, ks), dequantized(vq, vs), kl)
                for q, kq, ks, vq, vs, kl in gathered_sets[:8]]
    k2_ms = time_ms(da.decode_attention, deq_sets)
    pages_read = int(((kv_len.clamp(max=s) + PAGE_SIZE - 1)
                      // PAGE_SIZE).sum())
    row = _row("paged_decode_attention_quantized",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:668",
               main_path["launches_int8_paged"][
                   "paged_decode_attention_quantized"],
               errs_q[("k8", i8)], ms, plain_ms, flops,
               nbytes + 4 * pages_read, None, ops_dtype=i8)
    row["k7_gathered_ms"] = k7_ms
    row["k2_dequantized_ms"] = k2_ms
    rows.append(row)
    return rows


def _row(name, source, replaces, launches, err, ms, plain_ms, flops,
         nbytes, lib_ms, ops_dtype=torch.bfloat16) -> dict:
    t_ops = flops / PEAK_FLOPS[ops_dtype] * 1e3
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
    from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                           SyntheticLM)
    from repro_torch.kernels import _build, quant
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.attention import naive_attention
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

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
    errs_pa = check_paged_decode(da, gen)
    errs_q = check_quantized(fa, da, quant, gen)
    errs_bwd = check_flash_bwd(fa, naive_attention, gen)
    check_reduced_model(get_config, Model, Engine, ServeConfig)
    check_reduced_training(get_config, Model, opt, make_train_step,
                           DataConfig, SyntheticLM, launch_train, fa)
    main_path = serve_full_width(get_config, Model, Engine, ServeConfig,
                                 fa, da)
    check_full_width_gradient(get_config, Model, DataConfig, SyntheticLM,
                              fa)
    main_path.update(train_full_width(
        get_config, Model, opt, make_train_step, DataConfig, SyntheticLM,
        PrefetchIterator, fa, da))
    rows = kernel_rows(fa, da, gen, main_path, errs_fa, errs_da, errs_pa)
    rows += quant_kernel_rows(fa, da, quant, gen, main_path, errs_q)
    rows.append(bwd_kernel_row(fa, gen, main_path, errs_bwd))
    for r in rows:
        say("6 kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                           for k, v in r.items()
                           if k not in ("route", "source", "replaces")})
    say("done", total_s=f"{time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
