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

The Mamba2 path (K12, the SSD chunked scan, and K13, the same over
int8/fp8 x) adds three phases and two kernel rows: 3c, K12 against its
plain version at the main-path shape (B=1, S=512, H=48, P=64, N=128, G=1),
a ragged S=488, a shape with an initial state, a G=2 shape and the
reduced model's, in bf16 and f32, each call repeated bit for bit, and K13
(int8 and fp8 x, bf16 and f32 B/C) against its plain version and, in f32,
against K12 on the dequantized x; 4c, the reduced f32 mamba2-780m served
on the card against the CPU (first-token and decode logits, greedy tokens
on the contiguous and the paged cache, K12 launched once per layer and
multi-token prompt); 5c, full-width mamba2-780m in bf16 (random weights
from the seed) serving the 16 requests of phase 5 through 8 slots,
contiguous and then paged (equal tokens, no page allocated, K12 launched
48 times per multi-token prompt and no attention kernel), a profiled
488-token prefill and decode tick, and K13 through its op on the
activations of every layer of that prefill (x quantized to int8).

The MoE/MLA path (deepseek-v2-lite-16b: K14, the grouped expert matmul,
K15, the same over int8/fp8 weights, and K1/K2 at MLA's head shapes)
adds four phases and two kernel rows: 2d, K14 against its plain version
at the reduced, decode (gate/up and down), 488-token prefill and ragged
shapes, bf16 and f32, each call repeated bit for bit, and K15 (int8 and
fp8 weights) against its plain version and against K14 on the
dequantized weights; 2e, K1 at (Dk, Dv) = (192, 128) and (24, 16) and K2
at (576, 512) and (40, 32) against their plain versions, and K3 on a
paged copy of the MLA decode rows equal to K2 bit for bit (phase 3
re-checks K3 == K2 and K8 == K7 at the square shapes); 4d, the reduced
f32 deepseek-v2-lite on the card against the CPU (logits, greedy tokens
on the contiguous cache, K14 launched 3 times per MoE layer of every
forward); 5d, full-width deepseek-v2-lite-16b in bf16 (random weights
from the seed, after every earlier phase's tensors are freed) serving
the 16 requests of phase 5 through 8 slots on the contiguous cache
(K1, K2 and K14 launched, 78 K14 launches a forward, nothing else), a
profiled 488-token prefill and decode tick, the peak memory, and K15
through its op on that prefill's expert buffers with int8 gate weights.
The K1 and K2 rows gain ``mla_*`` fields (their times, bounds, plain and
library times and launches at the MLA shapes).

The tuned path (K4, K5, K6 and K9, the pipelined attention kernels, and
the measured autotuner) adds two phases and four kernel rows.  Every
other phase runs with ``REPRO_TUNING=off`` (the classic kernels, whatever
tuning db lies around).  3p: K4, K5, K6 and K9 at ring depths 2 and 4
equal to K1, K2, K3 and K8 bit for bit at the main-path shapes (K6 with
table entries past each row's length out of the pool; K9 on int8 and fp8
pools) and at the MLA pairs (K5 at (576, 512) fitted to depth 2).  5t,
on phase 5's model and requests: the measured search for the main-path
buckets (``REPRESENTATIVE_SHAPES``) into a db under ``build/``, its table
printed; serves with dbs pinned to depth 2 and 4 on the contiguous (K4,
K5), paged (K4, K6) and int8 paged (K10, K9) caches, tokens equal to
phase 5's classic runs and no classic attention kernel launched; the same
serves with the tuned db (the configs it picked, tokens/s, a profiled
decode tick and 512-wide prefill); and ``ServeConfig(page_size=None)``
under the tuned db, tokens equal to a paged run at the page size it
resolves.  No serve takes a timed measurement.  Phase 6 gains the rows
of K4, K5, K6 and K9: each at depths 2 and 4 beside its classic kernel,
timed in turns on the same inputs, with the classic's bound, plain time
and library call (SDPA for K4 and K5).

The flash pair on the tensor cores: in bf16, K1 and K4 (one mainloop
templated on the ring depth, depth 1 being K1) and K11 run their
products as ``mma.sync`` on raw bf16 tiles; f32 keeps the CUDA-core
kernels.  Phases 2, 2b, 2e, 3p and 7 drive both paths (bf16 and f32) and
name the path in their lines; phase 2 adds ragged bf16 and f32 cases
(Sq and Skv of 1, 63, 65, 1000, a per-row kv_len of 0, q_offset beyond
kv_len, not causal, rows that see no KV row: out 0, lse <= -1e29); 3p
holds ``pipelined_smem`` to the library's ring in both layouts.  The
K1, K4 and K11 rows gain ``path`` ("mma" for bf16).

The decode pair on the tensor cores: in bf16, K2, K3, K5 and K6 (one
split kernel templated on the ring depth and the row address) run their
products as ``mma.sync`` over ``cp.async`` rings, and K14 at C <= 32 (every
decode product) streams the weights through the tensor cores; f32, the
quantized caches (K7, K8, K9) and K15 keep their kernels.  Phase 1 reports
each library's build seconds and ``ptxas``'s registers and spills of every
instantiation of the two new kernels; phase 3 adds bf16 K2 at every
(Dk, Dv) pair with ragged lengths and a 0 against its plain version, K5
== K2 and K6 == K3 at depths 2 and 4 and K3 == K2 on the gathered rows at
two page placements, bit for bit; phases 5, 5t and 5d check that every
bf16 decode-attention launch of the serves ran the tensor-core kernel and
every decode-tick K14 launch the weight stream (the wrappers count
launches by path), and 2d holds K14 at C = 1, 13 and 32 to its plain
version; the K2, K3, K5, K6 and K14 rows gain ``path``.

The scan and the quantized flash forward on the tensor cores: in bf16,
K12 and K13 (one kernel over a bf16 or 1-byte x, 32 head-dim columns a
block) run the four products of a chunk as ``mma.sync`` behind a
``cp.async`` ring, and K10 converts each 1-byte K/V tile to bf16 once per
block and runs K1's per-tile arithmetic with the scales; f32 keeps the
CUDA-core kernels.  Phase 1 reports ``ptxas``'s registers and spills of
their instantiations (0 spills expected); phase 3 adds bf16 K10 at phase
2's ragged cases, int8 and fp8 (rows that see no KV row: out 0, lse <=
-1e29); 3c holds bf16 K13 to bf16 K12 on the dequantized x rounded to
bf16, bit for bit; phases 5, 5t and 5c check that every bf16 K10 and K12
launch of the serves ran the tensor-core kernel (the wrappers count
launches by path), and phase 5 profiles an int8 and an fp8 512-wide
prefill; the K10, K12 and K13 rows gain ``path``.

The 1-byte kernels on the tensor cores: bf16 queries over an int8 or e4m3
cache run K7, K8 and K9 as one 1-byte sibling of the decode split kernel
(the tile's bytes through a ``cp.async`` ring, made into bf16 once per
block, K2's tile arithmetic with the scales), and bf16 K15 at C <= 32
streams its 1-byte weights through the tensor cores as K14 streams bf16
ones; f32 keeps the CUDA-core kernels.  Phase 1 reports ``ptxas``'s
registers and spills of their instances (0 spills expected); phases 3,
3p, 5 and 5t check that every bf16 K7, K8 and K9 launch ran ``mma``; 2d
holds bf16 K15 at C = 1, 8, 13 and 32 to its plain version and to K14 on
the dequantized weights; phase 4 serves the reduced qwen2.5-3b in bf16
on an int8 cache (K10, K7, K8) against the CPU, first-token and 3 decode
steps' logits within ``BF16_INT8_LOGIT_REL_TOL``; phase 5 holds the
full-width int8 cache's first-token logits (K10) to the bf16 cache's
within ``INT8_KV_LOGIT_REL_TOL``; 5d runs K15 through its op on a decode
tick's expert buffers (the weight stream) as well as the prefill's; the
K7, K8, K9 and K15 rows gain ``path``.

Speculative decoding and serve fault degradation add two phases on
phase 5's model and requests (no kernel).  5s, at a draft span of
``SPEC_K``: ``verify_step``'s logits at every position equal the ticks'
that consume the same tokens bit for bit, on a contiguous and a paged
cache (K2 / K3 once a position and layer), with one verify profiled
beside ``SPEC_K + 1`` ticks; then speculative serves held to phase 5's
greedy tokens bit for bit: the self drafter (the target itself)
contiguous and paged, a cold 2-layer drafter from seed 1, and the self
drafter over an int8 cache (held to the int8 greedy run); the self
drafter must accept every proposal the budget does not cut, and each
run launches only K1 and K2 (K3 for the paged verify, K10 and K7 on
int8), on the tensor cores.  5f: one request poisoned at admission, one
at decode step 4 and two stalled ticks end with exactly those two
FAILED and the other 14 equal to phase 5's; a self-drafter run with a
draft-poisoned request gives phase 5's tokens with degraded ticks and
no failure.  The K1, K2, K3, K7 and K10 rows gain ``spec_launches``.

Temperature sampling, rounds mode and the hybrid family (zamba2-2.7b,
whose shared attention block has 32 query heads on 32 KV heads of 80)
add six phases.  Phase 1 prints ``ptxas``'s registers and spills of
every head_dim 80 instance of the four tensor-core attention kernels (0
spills expected).  2h and 3h: K1-K10 at head dim 80 and zamba2's G = 1
against their plain versions in bf16 and f32 (K1 and K10 at the
488-token prefill, K1 at phase 2's ragged cases, K2 and K7 at phase 3's
ragged lengths and a 0), K3 and K8 on a pool equal to K2 and K7 on the
gathered rows, K4, K5, K6 and K9 at depths 2 and 4 equal to K1, K2, K3
and K8 bit for bit, and ``pipelined_smem`` equal to the library's ring
at (80, 80).  4h: the reduced f32 zamba2 at head dim 80 (4 query heads
on 4) on the card against the CPU (logits, every cache leaf, tokens on
both caches, paged equal to contiguous, launch counts).  4r: the
reduced f32 qwen2.5-3b at temperature 0.8 on the card against the CPU
(continuous), and rounds and per-request ``generate`` equal to it on the
card.  5h: full-width zamba2-2.7b in bf16 (weights from the seed)
serving phase 5's 16 prompt lengths contiguous, paged, int8 and int8
paged (K12 54 times and K1 / K10 9 times a prompt, K2 / K3 / K7 / K8 9
times a tick, all on the tensor cores; paged tokens equal contiguous),
profiled 488-token prefills and ticks.  5r, on phase 5's model and
requests at temperature 0.8: another admission policy and the paged
cache give the continuous run's tokens, and at one slot rounds and
per-request ``generate`` give the one-slot continuous run's; at 8 slots,
where a rounds cohort's batched prefill may round its bf16 products
otherwise, a continuous serve fed the cohorts' prefill rows gives the
rounds tokens bit for bit, and a request whose own prefill is bit-equal
to its cohort row gives equal tokens; the sampler's device ms and
kernels a draw.  3c adds zamba2's scan shape (80 heads, P = N = 64) to
K12's cases.  Phase 6 times K1-K10 with the same row functions at
qwen2.5-3b's shape and again at zamba2's, whose numbers join each row
as ``d80_*`` fields (time, bound, plain, SDPA, 5h's launches); the K12
row gains ``hybrid_*`` fields at zamba2's scan.

The trainer's selective remat and the host calibrator add two phases.
7d, after phase 7's steps on its model and optimizer state: one step of 2
microbatches over 4 x 1024 tokens under ``remat_policy="dots"`` (the
outputs of the products without batch dimensions saved, the rest, K1
included, recomputed), its loss and every gradient leaf equal bit for bit
to a ``"full"`` step's on the same params and batch, K1 and K11 launched
as often (144 and 72), the ``mm`` calls that launch a GEMM as many as a
``"none"`` step runs; its peak memory, wall ms and a profile.  8, the
host FAA calibrator on this machine: ``measure_host`` (FAA, contended
transfer and dispatch ns of the host CPU), ``run_calibration`` at full
size with that measurement, the fit on the card and on the CPU (points,
fit loss, wall s; the two fits agree as the CPU tests hold the port to
the JAX package), a profile of the eager fit's steps on the card, the
ranking against the event model on the paper's platforms and this host,
the knobs under the calibrated context beside the default's, and
``launch.calibrate --no-persist``.  Every phase runs with
``REPRO_CALIBRATION=off`` and the default context; phase 8 installs its
calibrated contexts in memory only, resets the default afterwards and
leaves no calibration file.

The encoder-decoder (seamless-m4t-large-v2) and vision
(llama-3.2-vision-11b) families run through ``Engine.generate`` with
their frames or patches, every attention call on K1, and add three
phases.  2x: K1 against its plain version in bf16 and f32 at every
shape of their prefills and ticks (``CASES_2X``): seamless's encoder over
128 frames, its decoder's causal self-attention over the 1,024-row cache
(a 512-token prefill, and a tick's one query with a scalar ``kv_len``)
and its cross-attention at a prefill and a tick, 16 query heads on 16 of
64; llama-vision's self blocks at the same prefill and tick and its
cross-attention over 1,601 patch rows at a prefill and a tick, 32 on 8
of 128; every bf16 launch on ``mma``.  4x: the reduced f32
configurations at the full models' head shapes (64-wide heads at G = 1,
128-wide at G = 4; the vision cross gates at 0.5: at their initial 0 a
cross block adds nothing) on the card against the CPU: first-token and 3
decode steps' logits, every cache leaf after the prefill and the last
step, 6 greedy ``generate`` tokens, K1 once per attention call of each
prefill and tick and no other kernel.  5x: full-width seamless-m4t, then
full-width llama-vision (9.77 B parameters, after the earlier tensors are
freed), in bf16 with weights from the seed and gates at 0.5, through
``generate`` on 8 rows of 512 tokens (frames [8, 128, 1024], patches [8,
1601, 4096]), 32 new tokens: K1 alone launched, 72 times a prefill and
48 a tick (40 and 40), all on ``mma``; greedy tokens equal across two
calls; decode steps 1-4 against one prefill over the prompt and the
tokens so far within ``HIT_LOGIT_REL_TOL``; zeroing the frames or
patches moves the first-token logits by more than ``MODAL_MOVED_MIN`` of
the largest; ``serve()``, an int8 cache and ``generate(lengths=...)``
refused; then, printed, a temperature 0.8 ``generate(seed, rids)``'s
tokens/s, a profiled prefill and tick and the peak memory.  The K1 row gains
``encdec_*`` and ``vlm_*`` fields: its time, bound, plain time and one
SDPA call's at the cross prefill and the one-query cross tick, and
5x's launches; the vision tick adds ``vlm_tick_k2_ms``, K2 on the same
rows (not on the path).

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory without the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 0
KERNELS = ("flash_attention", "decode_attention", "mamba_ssd", "moe_gmm")
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate, f32 rate outside the tensor cores, dense int8 / fp8 tensor-core
# rate, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12}
PEAK_BYTES = 3.35e12
QDTYPES = (torch.int8, torch.float8_e4m3fn)
# The path a dtype's K1 / K4 / K10 / K11 / K12 / K13 call runs: bf16 on
# the tensor cores (mma.sync), f32 on the CUDA cores.
PATHS = {torch.bfloat16: "mma", torch.float32: "cuda_cores"}
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
# Reduced bf16 model on an int8 cache, card (K10, K7, K8) against CPU
# (their plain versions), first-token and decode logits as a share of the
# largest |logit|.  The two differ where bf16 rounds (the kernels round P
# to bf16 for the tensor cores, the plain versions keep f32; cuBLAS and
# the CPU round the projections' sums differently) and so, now and then,
# in an int8 step of a K/V value each side quantizes: the reason and the
# size of ``HIT_LOGIT_REL_TOL``.
BF16_INT8_LOGIT_REL_TOL = 5e-2
# Full-width bf16 model: an int8 cache's first-token logits (K10 over the
# quantized K/V) against a bf16 cache's, as a share of the largest
# |logit|.  Per-row int8 rounds each K/V value to within amax / 254, and
# 36 layers carry that error forward: the runs PERF.md records measured
# 2.05-2.15 % (H100 80GB HBM3, 700 W).  The bound sits near 5x that, to
# catch a kernel that reads the wrong rows or scales, not the rounding.
INT8_KV_LOGIT_REL_TOL = 1e-1
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
# K12 / K13 against their plain versions: the largest |difference| over
# the largest |value|, of y and of the f32 final state.  f32: summation
# order (and the order of the chunk's cumulative sum) only.  bf16 y: both
# round an f32 result to bf16 once, at most one bf16 ulp (2^-7 of a
# value); the final state stays f32.
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 1e-5
# K13 through its op on the full-width model's activations: y over int8 x
# against K12's y over the bf16 x, relative to max |y| (per-vector int8
# rounds each x to within amax / 254; y is linear in x).
K13_PATH_REL_TOL = 5e-2


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def tensor_core_spills(log: Path) -> tuple:
    """(kernels, bytes): how many tensor-core flash kernels ``nvcc``'s
    ``-Xptxas -v`` report names, and the spill stores and loads it reports
    for them together (0: every product's operands stay in registers)."""
    kernels, spilled, current = 0, 0, ""
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = entry.group(1)
            kernels += "mma_kernel" in current
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and "mma_kernel" in current:
            spilled += int(spill.group(1)) + int(spill.group(2))
    return kernels, spilled


# the mangled names of a kernel's storage-type template argument
MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "a": "int8",
                 "13__nv_fp8_e4m3": "fp8"}


def ptxas_report(log: Path, kernel: str) -> dict:
    """``ptxas``'s registers and spill bytes (stores + loads) of every
    instantiation of ``kernel`` in a library's ``-Xptxas -v`` log, keyed by
    its template arguments ("576/512/d2/PagedRows" for the decode kernel,
    "int8/128/d2/PagedRows" for its 1-byte sibling, "int8/4" for the
    weight stream's weights and n-tiles, "int8/32/128" for the scan's
    storage type, head-dim columns a block and N)."""
    out, current = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            current = None
            if kernel in name:
                tmpl = name.split(kernel, 1)[1]
                args = re.findall(r"Li(\d+)E", tmpl)
                rows = re.search(r"(ContiguousRows|PagedRows)", name)
                kind = MANGLED_TYPES.get(tmpl[1:].split("Li", 1)[0], "")
                if rows and len(args) == 2:      # (D, depth): 1-byte decode
                    current = f"{args[0]}/d{args[1]}"
                elif len(args) > 1:
                    current = "/".join(args[:2] + [f"d{a}" for a in args[2:3]])
                    current += f"/{rows.group(1)}" if rows else ""
                else:
                    current = args[0] if kind else f"NT{args[0]}"
                current = f"{kind}/{current}" if kind else current
                out[current] = [0, 0]
        if current is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[current][0] = int(regs.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[current][1] = int(spill.group(1)) + int(spill.group(2))
    return out


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

# b, sq, skv, kv_len, q_offset, causal: the edges of the tensor-core
# path's 64-row tiles (B=2, Hq=16, Hkv=2, D=128)
RAGGED_FLASH_CASES = [(2, 1, 63, [1, 0], 0, True),
                      (2, 65, 1000, [40, 1000], 100, True),
                      (1, 1000, 1000, 999, 0, False),
                      (1, 100, 65, None, None, True)]


def sees_no_row(out, lse, b, sq, skv, kv_len, q_offset, causal) -> bool:
    """Every query row that sees no KV row got out 0 and lse <= -1e29."""
    offset = skv - sq if q_offset is None else q_offset
    seen = torch.as_tensor(skv if kv_len is None else kv_len,
                           device="cuda").broadcast_to((b,))
    seen = seen[:, None].expand(b, sq)
    if causal:
        seen = torch.minimum(
            seen, torch.arange(sq, device="cuda")[None] + offset + 1)
    blind = seen <= 0
    return (bool((out[blind] == 0).all())
            and bool((lse.permute(0, 2, 1)[blind] <= -1e29).all()))


def check_flash(fa, gen) -> dict:
    """K1 vs plain: B=1, Hq=16, Hkv=2, D=128, Skv=1024; Sq in {16, 512}
    with kv_len = Sq and q_offset = 0 (the serve prefill), once with the
    defaults (suffix alignment), and Sq = 37 after 256 cached tokens (the
    continuation prefill of a prefix hit: q_offset = 256, kv_len = 293);
    then the ragged cases (``RAGGED_FLASH_CASES``), where a query row that
    sees no KV row must get out 0 and lse <= -1e29."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, skv, kv_len, q_offset, causal in RAGGED_FLASH_CASES:
            q = randn(gen, (b, sq, 16, 128), dtype)
            k = randn(gen, (b, skv, 2, 128), dtype)
            v = randn(gen, (b, skv, 2, 128), dtype)
            kl = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                  if isinstance(kv_len, list) else kv_len)
            out, lse = fa.flash_attention(q, k, v, kv_len=kl,
                                          q_offset=q_offset, causal=causal)
            ref, ref_lse = fa.flash_attention_plain(
                q, k, v, kv_len=kl, q_offset=q_offset, causal=causal)
            err = max_err(out, ref)
            what = f"K1 {dtype} ragged sq={sq} skv={skv} kv_len={kv_len}"
            expect(err <= TOL[dtype] and max_err(lse, ref_lse) <= 1e-3,
                   f"{what}: err {err}")
            expect(sees_no_row(out, lse, b, sq, skv, kv_len, q_offset,
                               causal), f"{what}: a row that sees no KV row")
            errs[(dtype, f"{sq}x{skv}", str(kv_len))] = err
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
    say("2 K1 vs plain", bf16_path=PATHS[torch.bfloat16],
        f32_path=PATHS[torch.float32],
        **{f"{str(d)[6:]}_sq{s}_kv{kl}".replace(" ", ""): f"{e:.3g}"
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


def pool_of_rows(k, v, seed, ps=PAGE_SIZE):
    """k [B, S, Hkv, Dk] and v [.., Dv] (S a multiple of ``ps``) as pages
    of a pool (page 0 scratch) placed by a seeded permutation: (k_pool,
    v_pool, table)."""
    b, s = k.shape[:2]
    pages = s // ps
    perm = torch.randperm(b * pages, generator=torch.Generator().manual_seed(
        seed)).cuda()
    pt = (perm.reshape(b, pages) + 1).to(torch.int32)
    pools = []
    for x in (k, v):
        pool = x.new_zeros((b * pages + 1, ps, *x.shape[2:]))
        pool[pt.long().flatten()] = x.reshape(b * pages, ps, *x.shape[2:])
        pools.append(pool)
    return (*pools, pt)


def check_mma_decode(da, gen) -> dict:
    """bf16 K2 (the tensor-core split kernel) against its plain version at
    every (Dk, Dv) pair of ``HEAD_DIM_PAIRS``: B = 9, S = 1024, phase 3's
    ragged lengths and a 0 (whose row must be zeros), the square pairs at
    G = 8 over 2 KV heads, the MLA pairs at G = 16 over one; K5 at depths
    2 and 4 (fitted: (576, 512) takes 2) equal to K2, K3 on a pool equal
    to K2 on the gathered rows under two page placements, and K6 at those
    depths equal to K3, all bit for bit."""
    bf16 = torch.bfloat16
    kv_len = torch.tensor([1, 100, 1024, 2000, 513, 64, 300, 777, 0],
                          dtype=torch.int32, device="cuda")
    errs = {}
    for dk, dv in da.HEAD_DIM_PAIRS:
        hkv, g = (2, 8) if dk == dv else (1, 16)
        q = randn(gen, (9, g * hkv, dk), bf16)
        k = randn(gen, (9, 1024, hkv, dk), bf16)
        v = randn(gen, (9, 1024, hkv, dv), bf16)
        what = f"bf16 K2 ({dk}, {dv})"
        expect(da.path(q, k) == "mma", f"{what}: not on the tensor cores")
        base = da.decode_attention(q, k, v, kv_len, num_buffers=1)
        err = max_err(base, da.decode_attention_plain(q, k, v, kv_len))
        expect(err <= TOL[bf16] and bool((base[8] == 0).all()),
               f"{what}: err {err} against the plain version")
        errs[(dk, dv)] = err
        depths = [da.route(q, k, v, num_buffers=d).num_buffers
                  for d in (2, 4)]
        for depth in depths:
            expect(torch.equal(da.decode_attention_pipelined(
                q, k, v, kv_len, num_buffers=depth), base),
                f"{what}: K5 at depth {depth} differs from K2")
        for seed in (1, 2):
            k_pool, v_pool, pt = pool_of_rows(k, v, seed)
            k3 = da.paged_decode_attention(q, k_pool, v_pool, pt, kv_len,
                                           num_buffers=1)
            expect(torch.equal(k3, base),
                   f"{what}: K3 (placement {seed}) differs from K2 on the "
                   "gathered rows")
            for depth in depths:
                expect(torch.equal(da.paged_decode_attention_pipelined(
                    q, k_pool, v_pool, pt, kv_len, num_buffers=depth), k3),
                    f"{what}: K6 at depth {depth} differs from K3")
            del k_pool, v_pool
    torch.cuda.synchronize()
    say("3 bf16 K2 K3 K5 K6 on the tensor cores vs plain",
        kv_len=kv_len.tolist(), k5_equals_k2=True, k3_equals_k2=True,
        k6_equals_k3=True, placements=2, depths="2,4 (576/512: 2)",
        **{f"{dk}_{dv}": f"{e:.3g}" for (dk, dv), e in errs.items()})
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
    K/V quantized from N(0, 1) draws): K10 at the prefill shapes and the
    ragged cases of ``check_flash`` (bf16: the tensor-core kernel; rows
    that see no KV row get out 0 and lse <= -1e29), K7 and K8 at K2's and
    K3's ragged lengths (bf16: the 1-byte tensor-core split kernel, every
    launch counted on ``mma``), and K8 on the pool == K7 on the gathered
    values and scales, bit for bit."""
    bf16 = torch.bfloat16
    errs = {}
    decode = (da.decode_attention_quantized,
              da.paged_decode_attention_quantized)
    before = [dict(fn.path_launches) for fn in decode]
    for store in QDTYPES:
        name = str(store)[6:]
        for b, sq, skv, kv_len, q_offset, causal in RAGGED_FLASH_CASES:
            q = randn(gen, (b, sq, 16, 128), bf16)
            kq, ks = quantized(quant, randn(gen, (b, skv, 2, 128), bf16),
                               store)
            vq, vs = quantized(quant, randn(gen, (b, skv, 2, 128), bf16),
                               store)
            kl = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                  if isinstance(kv_len, list) else kv_len)
            args = dict(kv_len=kl, q_offset=q_offset, causal=causal)
            out, lse = fa.flash_attention_quantized(q, kq, ks, vq, vs, **args)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_quantized_plain(
                q, kq, ks, vq, vs, **args)
            err = max_err(out, ref)
            what = f"K10 {name} ragged sq={sq} skv={skv} kv_len={kv_len}"
            expect(err <= TOL[bf16] and max_err(lse, ref_lse) <= 1e-3,
                   f"{what}: err {err}")
            expect(sees_no_row(out, lse, b, sq, skv, kv_len, q_offset,
                               causal), f"{what}: a row that sees no KV row")
            errs[("k10", store, f"{sq}x{skv}", str(kv_len))] = err
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
    grew = [{p: n - b.get(p, 0) for p, n in fn.path_launches.items()
             if n > b.get(p, 0)} for fn, b in zip(decode, before)]
    expect(grew == [{"mma": len(QDTYPES)}] * 2,
           f"K7 / K8 bf16: launches by path {grew}")
    say("3 K10 K7 K8 vs plain", k8_equal_to_k7_on_gathered=True,
        k10_path=PATHS[bf16], k7_k8_path=PATHS[bf16],
        **{"_".join(str(p).replace("torch.", "") for p in key): f"{e:.3g}"
           for key, e in errs.items()})
    return errs


# ----------------------------------------------------------------- phase 3p

def check_pipelined(fa, da, quant, gen) -> dict:
    """K4, K5, K6 and K9 at ring depths 2 and 4 against their plain
    versions (those of K1, K2, K3 and K8) within ``TOL`` (lse within
    1e-3), and against K1, K2, K3 and K8 at the main-path shapes: equal
    bit for bit (out and lse; K5 at K2's split plan).  K4 at the serve
    prefill (Sq = 512 into the 1024-row cache, kv_len 512) and a prefix
    hit's continuation (Sq = 37, q_offset 256), bf16 and f32; K5 and K6 at
    phase 3's ragged lengths (K6 from a seeded page placement, the table's
    entries past each row's length set out of the pool), bf16 and f32; K9
    on int8 and fp8 pools; and the MLA pairs in bf16: K4 at (192, 128), K5
    at (576, 512), where depth 4 does not fit and the op runs depth 2.
    Returns the largest error against the plain version over the depths."""
    bf16 = torch.bfloat16
    errs = {}

    def held(key, tol, got, want, what):
        err = max_err(got, want)
        expect(err <= tol, f"{what}: err {err} against the plain version")
        errs[key] = max(errs.get(key, 0.0), err)

    for dtype in (bf16, torch.float32):
        name = str(dtype)[6:]
        for sq, kv_len, q_offset in [(512, 512, 0), (37, 293, 256)]:
            q = randn(gen, (1, sq, 16, 128), dtype)
            k = randn(gen, (1, 1024, 2, 128), dtype)
            v = randn(gen, (1, 1024, 2, 128), dtype)
            base = fa.flash_attention(q, k, v, kv_len=kv_len,
                                      q_offset=q_offset, num_buffers=1)
            ref, ref_lse = fa.flash_attention_plain(
                q, k, v, kv_len=kv_len, q_offset=q_offset)
            for depth in (2, 4):
                got = fa.flash_attention_pipelined(
                    q, k, v, kv_len=kv_len, q_offset=q_offset,
                    num_buffers=depth)
                what = f"K4 {name} sq={sq} depth {depth}"
                expect(torch.equal(got[0], base[0])
                       and torch.equal(got[1], base[1]),
                       f"{what}: differs from K1")
                held(("k4", dtype, sq), TOL[dtype], got[0], ref, what)
                held(("k4_lse", dtype, sq), 1e-3, got[1], ref_lse, what)
        kv_len = [1, 100, 1024, 2000, 513, 64, 300, 777]
        q, kp, vp, pt, kl = paged_inputs(gen, dtype, kv_len, scratch_row=1)
        k, v = gathered(kp, pt), gathered(vp, pt)
        live = -(-kl.clamp(max=1024) // PAGE_SIZE)
        garbage = pt.clone()
        garbage[torch.arange(64, device="cuda")[None, :] >= live[:, None]] = (
            1 << 30)
        k2 = da.decode_attention(q, k, v, kl, num_buffers=1)
        k3 = da.paged_decode_attention(q, kp, vp, pt, kl, num_buffers=1)
        ref5 = da.decode_attention_plain(q, k, v, kl)
        ref6 = da.paged_decode_attention_plain(q, kp, vp, pt, kl)
        for depth in (2, 4):
            k5 = da.decode_attention_pipelined(q, k, v, kl, num_buffers=depth)
            k6 = da.paged_decode_attention_pipelined(q, kp, vp, garbage, kl,
                                                     num_buffers=depth)
            expect(torch.equal(k5, k2), f"K5 {name} depth {depth}: differs "
                   "from K2")
            expect(torch.equal(k6, k3), f"K6 {name} depth {depth}: differs "
                   "from K3")
            held(("k5", dtype), TOL[dtype], k5, ref5,
                 f"K5 {name} depth {depth}")
            held(("k6", dtype), TOL[dtype], k6, ref6,
                 f"K6 {name} depth {depth}")
    quant_ops = (da.paged_decode_attention_quantized,
                 da.paged_decode_attention_quantized_pipelined)
    before = [dict(fn.path_launches) for fn in quant_ops]
    for store in QDTYPES:
        q, kp, vp, pt, kl = paged_inputs(gen, bf16, kv_len, scratch_row=1)
        kq, ks = quantized(quant, kp, store)
        vq, vs = quantized(quant, vp, store)
        k8 = da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt, kl,
                                                 num_buffers=1)
        ref9 = da.paged_decode_attention_quantized_plain(q, kq, ks, vq, vs,
                                                         pt, kl)
        for depth in (2, 4):
            k9 = da.paged_decode_attention_quantized_pipelined(
                q, kq, ks, vq, vs, pt, kl, num_buffers=depth)
            what = f"K9 {store} depth {depth}"
            expect(torch.equal(k9, k8), f"{what}: differs from K8")
            held(("k9", store), TOL[bf16], k9, ref9, what)
    grew = [{p: n - b.get(p, 0) for p, n in fn.path_launches.items()
             if n > b.get(p, 0)} for fn, b in zip(quant_ops, before)]
    expect(grew == [{"mma": len(QDTYPES)}, {"mma": 2 * len(QDTYPES)}],
           f"K8 / K9 bf16: launches by path {grew}")
    q = randn(gen, (1, 488, 16, 192), bf16)
    k = randn(gen, (1, 488, 16, 192), bf16)
    v = randn(gen, (1, 488, 16, 128), bf16)
    base = fa.flash_attention(q, k, v, num_buffers=1)
    ref, ref_lse = fa.flash_attention_plain(q, k, v)
    for depth in (2, 4):
        got = fa.flash_attention_pipelined(q, k, v, num_buffers=depth)
        what = f"K4 MLA depth {depth}"
        expect(torch.equal(got[0], base[0]) and torch.equal(got[1], base[1]),
               f"{what}: differs from K1")
        held(("k4_mla",), TOL[bf16], got[0], ref, what)
        held(("k4_mla_lse",), 1e-3, got[1], ref_lse, what)
    q, k, v = mla_decode_inputs(gen, 8, 1024, 16, 576, 512, bf16)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    fitted = da.route(q, k, v, num_buffers=4).num_buffers
    expect(fitted == 2, f"K5 MLA: depth 4 fitted to {fitted}, not 2")
    k5 = da.decode_attention(q, k, v, kl, num_buffers=4)
    expect(torch.equal(k5, da.decode_attention(q, k, v, kl, num_buffers=1)),
           "K5 MLA depth 2: differs from K2")
    # the bytes the ops fit the depth against are the library's layout
    for depth in (2, 4):
        for ops, dk, dv, dtype, store in (
                (fa, 128, 128, bf16, None), (fa, 192, 128, bf16, None),
                (fa, 24, 16, bf16, None), (fa, 128, 128, torch.float32, None),
                (fa, 192, 128, torch.float32, None),
                (da, 128, 128, bf16, None), (da, 576, 512, bf16, None),
                (da, 128, 128, bf16, torch.int8),
                (da, 64, 64, bf16, torch.float8_e4m3fn),
                (da, 128, 128, torch.float32, torch.int8)):
            shape = ((store or dtype).itemsize, dk, dv)
            if ops is da:      # the layout of the query dtype's path
                shape += (PATHS[dtype],)
            base, stage = ops.pipelined_smem(*shape)
            lib = (ops.ring_smem_bytes(dk, dv, depth, dtype) if store is None
                   else ops.ring_smem_bytes(dk, dv, depth, dtype, store))
            expect(lib == base + depth * stage,
                   f"{ops.__name__} ({dk}, {dv}) {store} depth {depth}: the "
                   f"library's ring takes {lib} bytes, pipelined_smem says "
                   f"{base + depth * stage}")
    held(("k5_mla",), TOL[bf16], k5, da.decode_attention_plain(q, k, v, kl),
         "K5 MLA depth 2")
    torch.cuda.synchronize()
    say("3p K4 K5 K6 K9 vs plain and vs K1 K2 K3 K8", depths="2,4",
        k4_bf16_path=PATHS[bf16], k4_f32_path=PATHS[torch.float32],
        k8_k9_bf16_path=PATHS[bf16],
        equal=True, mla_k5_depth_fitted=fitted,
        **{"_".join(str(p).replace("torch.", "") for p in key): f"{e:.3g}"
           for key, e in errs.items()})
    return errs


# ------------------------------------------------- phases 2h, 3h: D = 80

D80 = 80            # zamba2's head dim: 32 query heads on 32 KV heads
HYBRID_ARCH = "zamba2-2.7b"


def check_d80(fa, da, quant, gen) -> dict:
    """K1-K10 at head_dim 80 (K11 is not built for it), at zamba2's
    attention shapes (32 query heads on 32 KV heads, G = 1), in bf16 (the
    tensor cores) and f32 (the CUDA cores), against their plain versions
    within ``TOL`` (lse within 1e-3): K1 and K10 at the 488-token prefill
    into the 1024-row cache, K1 also at phase 2's ragged cases (4 heads on
    4; rows that see no KV row get out 0 and lse <= -1e29), K10 int8 and
    fp8; K2 and K7 (int8, fp8) at B = 9, S = 1024 with phase 3's ragged
    lengths and a 0 (that row all zeros); K3 and K8 on a pool under two
    placements equal to K2 and K7 on the gathered rows; K4, K5, K6 and K9
    at depths 2 and 4 equal to K1, K2, K3 and K8 bit for bit; every bf16
    launch on ``mma``; and the ring layouts ``pipelined_smem`` mirrors at
    (80, 80).  Returns the errors against the plain versions."""
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    h = 32

    def held(key, got, want, what, tol):
        err = max_err(got, want)
        expect(err <= tol, f"{what}: err {err} against the plain version")
        errs[key] = max(errs.get(key, 0.0), err)

    def on_mma(q, k=None):
        return (fa.path(q) if k is None else da.path(q, k)) == PATHS[q.dtype]

    for dtype in (bf16, f32):
        name = str(dtype)[6:]
        q = randn(gen, (1, 488, h, D80), dtype)
        k = randn(gen, (1, 1024, h, D80), dtype)
        v = randn(gen, (1, 1024, h, D80), dtype)
        expect(on_mma(q), f"K1 {name} at D=80: path {fa.path(q)}")
        out, lse = fa.flash_attention(q, k, v, kv_len=488, q_offset=0,
                                      num_buffers=1)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=488,
                                                q_offset=0)
        held(("k1", dtype), out, ref, f"K1 {name} D=80", TOL[dtype])
        held(("k1_lse", dtype), lse, ref_lse, f"K1 {name} D=80 lse", 1e-3)
        for depth in (2, 4):
            got = fa.flash_attention_pipelined(q, k, v, kv_len=488,
                                               q_offset=0, num_buffers=depth)
            expect(torch.equal(got[0], out) and torch.equal(got[1], lse),
                   f"K4 {name} D=80 depth {depth}: differs from K1")
        errs[("k4", dtype)] = errs[("k1", dtype)]
        for store in QDTYPES:
            kq, ks = quantized(quant, k, store)
            vq, vs = quantized(quant, v, store)
            out, lse = fa.flash_attention_quantized(q, kq, ks, vq, vs,
                                                    kv_len=488, q_offset=0)
            ref, ref_lse = fa.flash_attention_quantized_plain(
                q, kq, ks, vq, vs, kv_len=488, q_offset=0)
            what = f"K10 {name} {str(store)[6:]} D=80"
            held(("k10", store, dtype), out, ref, what, TOL[dtype])
            held(("k10_lse", store, dtype), lse, ref_lse, what, 1e-3)
        for b, sq, skv, kv_len, q_offset, causal in RAGGED_FLASH_CASES:
            q = randn(gen, (b, sq, 4, D80), dtype)
            k = randn(gen, (b, skv, 4, D80), dtype)
            v = randn(gen, (b, skv, 4, D80), dtype)
            kl = (torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                  if isinstance(kv_len, list) else kv_len)
            args = dict(kv_len=kl, q_offset=q_offset, causal=causal)
            out, lse = fa.flash_attention(q, k, v, **args)
            ref, ref_lse = fa.flash_attention_plain(q, k, v, **args)
            what = f"K1 {name} D=80 ragged sq={sq} skv={skv} kv_len={kv_len}"
            held(("k1_ragged", dtype), out, ref, what, TOL[dtype])
            held(("k1_ragged_lse", dtype), lse, ref_lse, what, 1e-3)
            expect(sees_no_row(out, lse, b, sq, skv, kv_len, q_offset,
                               causal), f"{what}: a row that sees no KV row")
    torch.cuda.synchronize()
    say("2h K1 K4 K10 at head_dim 80 (32/32 heads) vs plain",
        bf16_path=PATHS[bf16], f32_path=PATHS[f32], k4_equals_k1=True,
        depths="2,4", **{"_".join(str(p).replace("torch.", "") for p in key):
                         f"{e:.3g}" for key, e in errs.items()})

    kv_len = torch.tensor([1, 100, 1024, 2000, 513, 64, 300, 777, 0],
                          dtype=torch.int32, device="cuda")
    for dtype in (bf16, f32):
        name = str(dtype)[6:]
        q = randn(gen, (9, h, D80), dtype)
        k = randn(gen, (9, 1024, h, D80), dtype)
        v = randn(gen, (9, 1024, h, D80), dtype)
        expect(on_mma(q, k), f"K2 {name} at D=80: path {da.path(q, k)}")
        base = da.decode_attention(q, k, v, kv_len, num_buffers=1)
        held(("k2", dtype), base, da.decode_attention_plain(q, k, v, kv_len),
             f"K2 {name} D=80", TOL[dtype])
        expect(bool((base[8] == 0).all()), f"K2 {name} D=80: a kv_len 0 row")
        depths = [da.route(q, k, v, num_buffers=d).num_buffers
                  for d in (2, 4)]
        for depth in depths:
            expect(torch.equal(da.decode_attention_pipelined(
                q, k, v, kv_len, num_buffers=depth), base),
                f"K5 {name} D=80 depth {depth}: differs from K2")
        errs[("k5", dtype)] = errs[("k2", dtype)]
        for seed in (1, 2):
            kp, vp, pt = pool_of_rows(k, v, seed)
            k3 = da.paged_decode_attention(q, kp, vp, pt, kv_len,
                                           num_buffers=1)
            expect(torch.equal(k3, base), f"K3 {name} D=80 (placement "
                   f"{seed}): differs from K2 on the gathered rows")
            for depth in depths:
                expect(torch.equal(da.paged_decode_attention_pipelined(
                    q, kp, vp, pt, kv_len, num_buffers=depth), k3),
                    f"K6 {name} D=80 depth {depth}: differs from K3")
            if seed == 1:
                held(("k3", dtype), k3, da.paged_decode_attention_plain(
                    q, kp, vp, pt, kv_len), f"K3 {name} D=80", TOL[dtype])
                errs[("k6", dtype)] = errs[("k3", dtype)]
            del kp, vp
        for store in QDTYPES:
            sname = f"{name} {str(store)[6:]}"
            kp, vp, pt = pool_of_rows(k.to(bf16), v.to(bf16), 1)
            kq, ks = quantized(quant, kp, store)
            vq, vs = quantized(quant, vp, store)
            del kp, vp
            k8 = da.paged_decode_attention_quantized(q, kq, ks, vq, vs, pt,
                                                     kv_len, num_buffers=1)
            rows = [gathered_bytes(quant, t, pt) for t in (kq, ks, vq, vs)]
            k7 = da.decode_attention_quantized(q, *rows, kv_len)
            held(("k7", store, dtype), k7,
                 da.decode_attention_quantized_plain(q, *rows, kv_len),
                 f"K7 {sname} D=80", TOL[dtype])
            held(("k8", store, dtype), k8,
                 da.paged_decode_attention_quantized_plain(
                     q, kq, ks, vq, vs, pt, kv_len), f"K8 {sname} D=80",
                 TOL[dtype])
            expect(torch.equal(k8, k7), f"K8 {sname} D=80: differs from K7 "
                   "on the gathered rows")
            for depth in (2, 4):
                expect(torch.equal(
                    da.paged_decode_attention_quantized_pipelined(
                        q, kq, ks, vq, vs, pt, kv_len, num_buffers=depth),
                    k8), f"K9 {sname} D=80 depth {depth}: differs from K8")
            errs[("k9", store, dtype)] = errs[("k8", store, dtype)]
            del kq, vq, rows
        del q, k, v
    # the bytes the ops fit the depth against are the library's layout
    for depth in (2, 4):
        for ops, dtype, store in ((fa, bf16, None), (fa, f32, None),
                                  (da, bf16, None), (da, f32, None),
                                  (da, bf16, torch.int8),
                                  (da, bf16, torch.float8_e4m3fn),
                                  (da, f32, torch.int8)):
            shape = ((store or dtype).itemsize, D80, D80)
            if ops is da:
                shape += (PATHS[dtype],)
            base_b, stage = ops.pipelined_smem(*shape)
            lib = (ops.ring_smem_bytes(D80, D80, depth, dtype)
                   if store is None else
                   ops.ring_smem_bytes(D80, D80, depth, dtype, store))
            expect(lib == base_b + depth * stage,
                   f"{ops.__name__} (80, 80) {store} depth {depth}: the "
                   f"library's ring takes {lib} bytes, pipelined_smem says "
                   f"{base_b + depth * stage}")
    torch.cuda.synchronize()
    say("3h K2 K3 K5 K6 K7 K8 K9 at head_dim 80 (G = 1) vs plain",
        kv_len=kv_len.tolist(), k3_equals_k2=True, k5_equals_k2=True,
        k6_equals_k3=True, k8_equals_k7=True, k9_equals_k8=True,
        placements=2, depths="2,4", smem_mirrors_library=True,
        **{"_".join(str(p).replace("torch.", "") for p in key): f"{e:.3g}"
           for key, e in errs.items()
           if key[0] in ("k2", "k3", "k7", "k8")})
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
    say("2b K11 vs plain", bf16_path=PATHS[torch.bfloat16],
        f32_path=PATHS[torch.float32],
        **{f"{str(dt)[6:]}_{name}_rel_dq_dk_dv":
           "/".join(f"{x:.3g}" for x in e["rel"])
           for (dt, name), e in errs.items()},
        function_vs_naive_rel_dq_dk_dv="/".join(f"{x:.3g}" for x in rel_fn))
    return errs


# ----------------------------------------------------------------- phase 3c

# (B, S, H, P, G, N, with an initial state): the main-path shape (one
# full-width mamba2-780m prefill of 512 tokens), the longest served prompt
# (488: a ragged last chunk of 40 rows), an initial state, two groups, the
# reduced model's P = N = 16, and zamba2-2.7b's scans at phase 5h's
# longest prompt (80 heads, P = N = 64)
SSD_CASES = {"main": (1, 512, 48, 64, 1, 128, False),
             "ragged": (1, 488, 48, 64, 1, 128, False),
             "state": (2, 200, 48, 64, 1, 128, True),
             "grouped": (2, 300, 16, 32, 2, 64, False),
             "reduced": (3, 37, 8, 16, 1, 16, True),
             "hybrid": (1, 488, 80, 64, 1, 64, False)}


def ssd_inputs(gen, b, s, h, p, g, n, dtype):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1)) and a =
    -exp(N(0, 1)) in f32 (the reference's kernel-test draws)."""
    x = randn(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(randn(gen, (b, s, h), torch.float32))
    a = -torch.exp(randn(gen, (h,), torch.float32))
    return (x, dt, a, randn(gen, (b, s, g, n), dtype),
            randn(gen, (b, s, g, n), dtype))


def rel_err(got, want) -> float:
    return max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def check_ssd(ss, quant, gen) -> dict:
    """K12 vs plain at ``SSD_CASES`` in bf16 and f32, each call repeated
    bit for bit; K13 (int8 and fp8 x, bf16 and f32 B/C) vs plain at the
    main and the ragged shape, in f32 against K12 on the dequantized x,
    and in bf16 equal to K12 on the dequantized x rounded to bf16, bit for
    bit (the tensor-core kernel over either x)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (b, s, h, p, g, n, with_state) in SSD_CASES.items():
            ins = ssd_inputs(gen, b, s, h, p, g, n, dtype)
            init = (randn(gen, (b, h, p, n), torch.float32) if with_state
                    else None)
            y, st = ss.ssd(*ins, initial_state=init)
            y2, st2 = ss.ssd(*ins, initial_state=init)
            torch.cuda.synchronize()
            want_y, want_st = ss.ssd_plain(*ins, initial_state=init)
            ey, es = rel_err(y, want_y), rel_err(st, want_st)
            expect(ey <= SSD_TOL[dtype] and es <= SSD_STATE_TOL,
                   f"K12 {dtype} {name}: relative errors y {ey}, state {es}")
            expect(torch.equal(y, y2) and torch.equal(st, st2),
                   f"K12 {dtype} {name}: a repeated call differs")
            errs[("k12", dtype, name)] = (ey, es, max_err(y, want_y))
    for store in QDTYPES:
        for dtype in (torch.bfloat16, torch.float32):
            for name in ("main", "ragged"):
                b, s, h, p, g, n, _ = SSD_CASES[name]
                x, dt, a, b_in, c_in = ssd_inputs(gen, b, s, h, p, g, n,
                                                  dtype)
                xq, xs = quantized(quant, x, store)
                y, st = ss.ssd_quantized(xq, xs, dt, a, b_in, c_in)
                torch.cuda.synchronize()
                want_y, want_st = ss.ssd_quantized_plain(xq, xs, dt, a,
                                                         b_in, c_in)
                ey, es = rel_err(y, want_y), rel_err(st, want_st)
                expect(y.dtype == dtype and ey <= SSD_TOL[dtype]
                       and es <= SSD_STATE_TOL,
                       f"K13 {store} {dtype} {name}: relative errors y {ey},"
                       f" state {es}")
                if dtype == torch.float32:
                    y12, st12 = ss.ssd(quant.dequantize(xq, xs), dt, a, b_in,
                                       c_in)
                    e12 = max(rel_err(y, y12), rel_err(st, st12))
                    expect(e12 <= SSD_TOL[dtype],
                           f"K13 {store} {name}: {e12} from K12 on the "
                           f"dequantized x")
                    errs[("k13_vs_k12", store, name)] = e12
                else:
                    # bf16: the same kernel on the same operands
                    y12, st12 = ss.ssd(quant.dequantize(xq, xs).to(dtype),
                                       dt, a, b_in, c_in)
                    expect(torch.equal(y, y12) and torch.equal(st, st12),
                           f"K13 {store} {name}: differs from bf16 K12 on "
                           f"the rounded x")
                errs[("k13", store, dtype, name)] = (ey, es, max_err(
                    y, want_y))
    say("3c K12 K13 vs plain", repeat_bit_equal=True,
        bf16_k13_equal_k12_on_rounded_x=True,
        path_bf16=PATHS[torch.bfloat16], path_f32=PATHS[torch.float32],
        **{"_".join(str(k).replace("torch.", "") for k in key):
           ("/".join(f"{x:.3g}" for x in e[:2]) if isinstance(e, tuple)
            else f"{e:.3g}") for key, e in errs.items()})
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


def check_reduced_bf16_int8(get_config, Model, fa, da) -> None:
    """The reduced qwen2.5-3b in bf16 on an int8 cache, on the card (K10,
    K7, and K8 through a paged copy of each row's prefill cache) against
    the CPU (their plain versions), from the same weights: the first-token
    logits and those of 3 decode steps fed the same tokens, each within
    ``BF16_INT8_LOGIT_REL_TOL`` of the CPU's largest |logit|; every K7 and
    K8 launch on ``mma``."""
    cfg = get_config("qwen2.5-3b").reduced().with_dtype("bfloat16")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED + 5)
    toks = rng.randint(1, cfg.vocab_size, (3, 32)).astype(np.int32)
    lens = np.array([32, 17, 5], np.int32)
    steps = rng.randint(1, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    max_len, ps = 64, 8
    pages = np.random.RandomState(SEED + 6).permutation(3 * max_len // ps) + 1

    def contiguous(model, params):
        logits, cache = model.prefill_padded(
            params, {"tokens": toks, "lengths": lens}, max_len, torch.int8)
        out = [logits.cpu()]
        for nxt in steps:
            logits, cache = model.decode_step(params, nxt, cache)
            out.append(logits.cpu())
        return out

    def paged(model, params):
        spec = model.cache_page_spec(dtype=torch.int8)
        axes = model.cache_batch_axes(dtype=torch.int8)
        pool = model.init_paged_cache(3, max_len, len(pages), ps, torch.int8)
        first = []
        per_row = max_len // ps
        for r in range(3):
            row = {"tokens": toks[r:r + 1, :lens[r]], "lengths": lens[r:r + 1]}
            logits, pre = model.prefill_padded(params, row, max_len,
                                               torch.int8)
            first.append(logits.cpu())
            phys = [int(p) for p in pages[r * per_row:(r + 1) * per_row]]
            model.write_page(pool, pre, phys, list(range(per_row)), spec=spec,
                             page_size=ps)
            pool = model.admit_paged_slot(pool, pre, r, int(lens[r]), phys,
                                          spec=spec, axes=axes)
        out = [torch.cat(first)]
        for nxt in steps:
            logits, pool = model.decode_step(params, nxt, pool)
            out.append(logits.cpu())
        return out

    errs = {}
    for name, run, kernel in (
            ("contiguous", contiguous, "decode_attention_quantized"),
            ("paged", paged, "paged_decode_attention_quantized")):
        want = run(cpu, params_cpu)
        torch.cuda.synchronize()
        reset_counts(fa, da)
        got = run(gpu, params_gpu)
        torch.cuda.synchronize()
        launches, paths = read_counts(fa, da), read_paths(fa, da)
        expect(launched_only(launches, ("flash_attention_quantized", kernel))
               and on_path(paths, ("flash_attention_quantized", kernel),
                           "mma"),
               f"reduced bf16 int8 {name}: launches {launches}, by path "
               f"{paths}")
        rel = [max_err(g, w) / w.float().abs().max().item()
               for g, w in zip(got, want)]
        expect(all(np.isfinite(rel)) and max(rel) <= BF16_INT8_LOGIT_REL_TOL,
               f"reduced bf16 int8 {name}: logits rel err {rel}")
        errs[name] = rel
    say("4 reduced bf16 int8-KV card vs CPU (first token, 3 decode steps; "
        "rel)", path="mma", **{
            f"{name}_{i}": f"{e:.3g}" for name, rel in errs.items()
            for i, e in enumerate(rel)})


def check_reduced_ssm(get_config, Model, Engine, ServeConfig, fa,
                      da) -> None:
    """The reduced f32 mamba2-780m on the card (K12) against the CPU (the
    plain scan): first-token logits and cache of a 100-token prefill (a
    ragged chunk), 3 decode steps, then greedy serve on the contiguous and
    the paged cache, K12 launched once per layer and multi-token prompt."""
    cfg = get_config("mamba2-780m").reduced()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED)
    toks = rng.randint(1, cfg.vocab_size, (2, 100)).astype(np.int32)
    lc, cc = cpu.prefill(params_cpu, {"tokens": toks}, 256, torch.float32)
    lg, cg = gpu.prefill(params_gpu, {"tokens": toks}, 256, torch.float32)
    prefill_err = max_err(lg.cpu(), lc)
    cache_err = max(rel_err(cg[k].cpu(), cc[k]) for k in cc)
    decode_err = 0.0
    for _ in range(3):
        nxt = rng.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        dc, cc = cpu.decode_step(params_cpu, nxt, cc)
        dg, cg = gpu.decode_step(params_gpu, nxt, cg)
        decode_err = max(decode_err, max_err(dg.cpu(), dc))
    expect(prefill_err <= LOGIT_TOL and decode_err <= LOGIT_TOL
           and cache_err <= LOGIT_TOL,
           f"reduced mamba2: prefill {prefill_err}, decode {decode_err}, "
           f"cache {cache_err}")
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 5, 37, 64, 100, 130, 17, 200, 3, 66)]
    multi = sum(len(p) > 1 for p in prompts)
    fields = {}
    outs = {}
    for cache in ("contiguous", "paged"):
        scfg = ServeConfig(max_len=256, slots=3, refill_schedule="faa",
                           cache=cache, page_size=PAGE_SIZE)
        out_cpu = Engine(cpu, params_cpu, scfg).serve(prompts, 12)
        eng = Engine(gpu, params_gpu, scfg)
        outs[cache], launches = drive(eng, prompts, fa, da, n_new=12)
        same = all(same_tokens(out_cpu, outs[cache]))
        expect(same and launched_only(launches, ("ssd",))
               and launches["ssd"] == cfg.n_layers * multi,
               f"reduced mamba2 {cache} serve: tokens equal {same}, "
               f"launches {launches}")
        fields[f"{cache}_tokens_equal_cpu"] = same
        fields[f"{cache}_launches_ssd"] = launches["ssd"]
        if cache == "paged":
            rep = eng.last_report
            expect(rep.pages_allocated == rep.peak_pages_live == 0,
                   f"reduced mamba2 paged serve: {rep.pages_allocated} "
                   f"pages allocated")
            fields["pages_allocated"] = rep.pages_allocated
    expect(all(same_tokens(outs["contiguous"], outs["paged"])),
           "reduced mamba2: paged tokens differ from contiguous")
    say("4c reduced f32 mamba2 serve card vs cpu",
        prefill_logit_err=f"{prefill_err:.3g}",
        decode_logit_err=f"{decode_err:.3g}",
        cache_rel_err=f"{cache_err:.3g}", requests=len(prompts),
        multi_token_prompts=multi, **fields)


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
    if "fa_fwd_kernel" in name or "fa_fwd_quant_mma_kernel" in name:
        return "k10" if quant else "k1"
    if "fa_fwd_pipelined_kernel" in name:
        return "k4"
    if "fa_fwd_mma_kernel" in name:     # bf16: K1 at ring depth 1, else K4
        depth = re.search(r"fa_fwd_mma_kernel<[^>]*?(\d+)\s*>", name)
        return "k1" if depth is None or depth.group(1) == "1" else "k4"
    if "fa_bwd_" in name:
        return "k11"      # dq, dk/dv and the GQA group sum
    if "decode_split_quant_mma_kernel" in name:   # bf16 q, 1-byte K/V
        depth = re.search(r"decode_split_quant_mma_kernel<[^,]*,\s*\d+\s*,"
                          r"\s*(\d+)", name)
        if "pagedrows" in name:
            return "k9" if depth and depth.group(1) != "1" else "k8"
        return "k7"
    if "decode_split_mma_kernel" in name:   # bf16: K2 / K3 at depth 1
        depth = re.search(r"decode_split_mma_kernel<\s*\d+\s*,\s*\d+\s*,"
                          r"\s*(\d+)", name)
        ring = depth is not None and depth.group(1) != "1"
        if "pagedrows" in name:
            return "k6" if ring else "k3"
        return "k5" if ring else "k2"
    if "decode_split_kernel" in name:
        if "pagedrows" in name:
            return "k8" if quant else "k3"
        return "k7" if quant else "k2"
    if "decode_split_pipelined_kernel" in name:
        if "pagedrows" in name:
            return "k9" if quant else "k6"
        return "k5"
    if "decode_combine_kernel" in name:
        return "combine"    # the second launch of K2, K3 and K5-K9
    if "ssd_kernel" in name or "ssd_mma_kernel" in name:
        return "k13" if quant else "k12"
    if any(k in name for k in ("gmm_kernel", "gmm_mma_kernel",
                               "gmm_stream_kernel")):
        return "k15" if quant else "k14"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def profile(fn, iters: int, top: int = 0) -> dict:
    """``fn`` timed on the host clock without a profiler (``wall_ms``),
    then one call under torch.profiler: the device time of its kernels by
    category (K1, K4, K10 and K11, the split kernels of K2, K3 and K5-K9,
    their shared combine kernel, K12, K13, K14, K15, matrix products, all
    other kernels; a
    category with no kernel is left out), their number and the number of
    matrix products, the device's idle share of the unprofiled wall time,
    and with ``top`` the names (cut to
    40 characters) and ms of the ``top`` largest kernels of "other"."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wall = wall_ms(fn, iters)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(("k1", "k4", "k10", "k11", "k2", "k3", "k5", "k6",
                        "k7", "k8", "k9", "k12", "k13", "k14", "k15",
                        "combine", "matmul", "other"), 0.0)
    kernels = matmuls = 0
    other: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            cat = _category(ev.name)
            ms[cat] += ev.device_time_total / 1e3
            kernels += 1
            matmuls += cat == "matmul"
            if cat == "other":
                name = ev.name[:40].replace(" ", "")
                other[name] = other.get(name, 0.0) + ev.device_time_total / 1e3
    busy = sum(ms.values())
    if busy == 0:
        return {"wall_ms": f"{wall:.2f}", "device_ms": "not measured"}
    largest = sorted(other.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": f"{wall:.2f}", "device_ms": f"{busy:.2f}",
            "idle_share": f"{max(0.0, 1 - busy / wall):.3f}",
            "kernels": kernels, "matmul_kernels": matmuls,
            **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items() if v > 0},
            **({"other_largest": ";".join(f"{n}={v:.1f}" for n, v in largest)}
               if largest else {})}


def wrappers(fa, da) -> dict:
    """Every kernel wrapper of the serve and training paths by name (each
    counts its launches), the SSD scans', grouped matmuls' and pipelined
    attention kernels' included."""
    from repro_torch.kernels.mamba_ssd import ops as ss
    from repro_torch.kernels.moe_gmm import ops as mg

    return {fn.__name__: fn for fn in (
        fa.flash_attention, da.decode_attention, da.paged_decode_attention,
        fa.flash_attention_quantized, da.decode_attention_quantized,
        da.paged_decode_attention_quantized, fa.flash_attention_bwd,
        ss.ssd, ss.ssd_quantized, mg.grouped_matmul,
        mg.grouped_matmul_quantized, fa.flash_attention_pipelined,
        da.decode_attention_pipelined, da.paged_decode_attention_pipelined,
        da.paged_decode_attention_quantized_pipelined)}


def reset_counts(fa, da) -> None:
    for fn in wrappers(fa, da).values():
        fn.launches = 0
        if hasattr(fn, "path_launches"):
            fn.path_launches.clear()


def read_counts(fa, da) -> dict:
    return {name: fn.launches for name, fn in wrappers(fa, da).items()}


def read_paths(fa, da) -> dict:
    """The launches since the last reset of each wrapper that counts them
    by the library's path (the attention ops, the scans and the grouped
    matmuls), by path: {name: {path: n}}."""
    return {name: dict(fn.path_launches)
            for name, fn in wrappers(fa, da).items()
            if getattr(fn, "path_launches", None)}


def on_path(paths: dict, names, path: str) -> bool:
    """Every launch of each wrapper in ``names`` ran ``path``."""
    return all(set(paths.get(n, {})) <= {path} for n in names)


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
    paths = read_paths(fa, da)
    rep = eng.last_report
    expect(launched_only(launches, ("flash_attention", "decode_attention"))
           and on_path(paths, ("decode_attention",), "mma"),
           f"contiguous main path: launches {launches}, by path {paths}")
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
        launches_decode=launches["decode_attention"],
        decode_path="mma")
    say("5 full-width bf16 serve", **result)

    # main path: paged, prefix cache off — the contiguous run's tokens bit
    # for bit, every decode tick through K3 and none through K2
    paged = dict(base, cache="paged", page_size=PAGE_SIZE)
    eng_p = Engine(model, params, ServeConfig(**paged, prefix_cache=False))
    eng_p.serve(prompts[:2], 2)                   # warm-up
    outs_p, launches_p = drive(eng_p, prompts, fa, da)
    paths_p = read_paths(fa, da)
    rep_p = eng_p.last_report
    expect(all(same_tokens(outs, outs_p)),
           "full-width paged serve: tokens differ from the contiguous run")
    expect(launched_only(launches_p, ("flash_attention",
                                      "paged_decode_attention"))
           and on_path(paths_p, ("paged_decode_attention",), "mma"),
           f"full-width paged serve: launches {launches_p}, by path "
           f"{paths_p}")
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
    spec_path = serve_speculative(cfg, model, params, Engine, ServeConfig,
                                  base, paged, prompts, (outs, rep),
                                  (quant_path["outs_int8"],
                                   quant_path.pop("rep_int8")), fa, da)
    serve_faulted(model, params, Engine, ServeConfig, base, prompts, outs,
                  fa, da)
    serve_sampled(model, params, Engine, ServeConfig, base, paged, prompts,
                  fa, da)
    tuned_path = serve_tuned_path(
        cfg, model, params, Engine, ServeConfig, base, paged, prompts, outs,
        quant_path.pop("outs_int8"),
        lambda: model.decode_step(params, tick, tick_cache), fa, da)
    del params, eng, model
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_paged": launches_p,
            "serve_lens": lens, "prefix": prefix, **quant_path,
            **spec_path, **tuned_path}


def serve_quantized(cfg, model, params, Engine, ServeConfig, base, paged,
                    prompts, outs_bf16, bf16_tick, fa, da) -> dict:
    """The quantized paths at full width, on the contiguous run's requests:
    int8 contiguous (K10, K7), int8 paged with the prefix cache off (K10,
    K8; tokens equal to int8 contiguous), fp8 contiguous, and an int8
    shared-prefix run; none of them launches K1, K2 or K3, and every K10,
    K7 and K8 launch (bf16 queries) runs its tensor-core kernel; then the
    int8 cache's first-token logits (K10) against the bf16 cache's within
    ``INT8_KV_LOGIT_REL_TOL``.  ``bf16_tick`` runs
    one decode tick of the bf16 contiguous run, timed in turns with the
    int8 tick; a 512-wide prefill into the int8 and into the fp8 cache is
    profiled."""
    q8 = dict(base, kv_dtype="int8")
    eng_c = Engine(model, params, ServeConfig(**q8))
    eng_c.serve(prompts[:2], 2)                   # warm-up
    outs_c, launches_c = drive(eng_c, prompts, fa, da)
    paths_c = read_paths(fa, da)
    rep_c = eng_c.last_report
    expect(launched_only(launches_c, ("flash_attention_quantized",
                                      "decode_attention_quantized"))
           and on_path(paths_c, ("flash_attention_quantized",
                                 "decode_attention_quantized"), "mma"),
           f"int8 contiguous serve: launches {launches_c}, by path "
           f"{paths_c}")
    expect(len(outs_c) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs_c), "int8 contiguous serve: malformed outputs")
    say("5 full-width int8-KV serve", tokens=rep_c.total_tokens,
        ticks=rep_c.total_ticks, wall_s=f"{rep_c.wall_s:.3f}",
        tokens_per_s=f"{rep_c.total_tokens / rep_c.wall_s:.1f}",
        launches_flash_quantized=launches_c["flash_attention_quantized"],
        launches_decode_quantized=launches_c["decode_attention_quantized"],
        k10_paths=paths_c["flash_attention_quantized"],
        k7_paths=paths_c["decode_attention_quantized"],
        share_equal_bf16=f"{np.mean(same_tokens(outs_bf16, outs_c)):.3f}")
    tick = np.zeros((8, 1), np.int32)
    tick_cache = eng_c._backend.cache
    def int8_tick():
        return model.decode_step(params, tick, tick_cache)

    torch.cuda.synchronize()
    reset_counts(fa, da)
    int8_tick()
    torch.cuda.synchronize()
    tick_paths = read_paths(fa, da)
    expect(tick_paths == {"decode_attention_quantized": {
        "mma": cfg.n_layers}}, f"int8 decode tick: by path {tick_paths}")
    decode = profile(int8_tick, 10)
    say("5 profile int8-KV decode tick (8 slots)", **decode)
    # host time of the two ticks in turns (bf16, int8, int8, bf16): the
    # host's drift between phases is larger than their difference
    turns = [wall_ms(fn, 10) for fn in (bf16_tick, int8_tick, int8_tick,
                                        bf16_tick)]
    say("5 decode tick wall ms in turns", bf16_a=f"{turns[0]:.2f}",
        int8_a=f"{turns[1]:.2f}", int8_b=f"{turns[2]:.2f}",
        bf16_b=f"{turns[3]:.2f}")
    prompt512 = np.zeros((1, 512), np.int32)
    prompt512[0] = np.random.RandomState(SEED + 4).randint(0, cfg.vocab_size,
                                                           512)

    def profile_prefill(eng, what):
        """A 512-wide prefill into ``eng``'s quantized cache: K10 launched
        once a layer, on the tensor cores; then profiled."""
        def prefill():
            return eng._prefill_padded(params, prompt512,
                                       np.array([512], np.int32))

        torch.cuda.synchronize()
        reset_counts(fa, da)
        prefill()
        torch.cuda.synchronize()
        launches, paths = read_counts(fa, da), read_paths(fa, da)
        expect(launched_only(launches, ("flash_attention_quantized",))
               and paths.get("flash_attention_quantized") == {
                   "mma": cfg.n_layers},
               f"{what} prefill: launches {launches}, by path {paths}")
        say(f"5 profile {what} prefill (width 512)", **profile(prefill, 5))

    profile_prefill(eng_c, "int8-KV")

    eng_p = Engine(model, params, ServeConfig(**dict(paged, kv_dtype="int8"),
                                              prefix_cache=False))
    eng_p.serve(prompts[:2], 2)                   # warm-up
    outs_p, launches_p = drive(eng_p, prompts, fa, da)
    paths_p = read_paths(fa, da)
    rep_p = eng_p.last_report
    expect(all(same_tokens(outs_c, outs_p)),
           "int8 paged serve: tokens differ from the int8 contiguous run")
    expect(launched_only(launches_p, ("flash_attention_quantized",
                                      "paged_decode_attention_quantized"))
           and on_path(paths_p, ("flash_attention_quantized",
                                 "paged_decode_attention_quantized"), "mma"),
           f"int8 paged serve: launches {launches_p}, by path {paths_p}")
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
    paths_f = read_paths(fa, da)
    rep_f = eng_f.last_report
    expect(launched_only(launches_f, ("flash_attention_quantized",
                                      "decode_attention_quantized"))
           and on_path(paths_f, ("flash_attention_quantized",
                                 "decode_attention_quantized"), "mma"),
           f"fp8 contiguous serve: launches {launches_f}, by path {paths_f}")
    expect(all(o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
               for o in outs_f), "fp8 contiguous serve: malformed outputs")
    say("5 full-width fp8-KV serve", tokens=rep_f.total_tokens,
        ticks=rep_f.total_ticks, wall_s=f"{rep_f.wall_s:.3f}",
        tokens_per_s=f"{rep_f.total_tokens / rep_f.wall_s:.1f}",
        share_equal_int8=f"{np.mean(same_tokens(outs_c, outs_f)):.3f}",
        launches_flash_quantized=launches_f["flash_attention_quantized"],
        launches_decode_quantized=launches_f["decode_attention_quantized"],
        k10_paths=paths_f["flash_attention_quantized"])
    profile_prefill(eng_f, "fp8-KV")
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
    paths_x = read_paths(fa, da)
    rep_x = eng_x.last_report
    expect(rep_x.prefix_hits >= 14
           and rep_x.prefix_hit_tokens == 256 * rep_x.prefix_hits
           and all(t.prefill_tokens + t.prefix_hit_tokens == t.prompt_len
                   for t in rep_x.requests),
           f"int8 prefix run: {rep_x.prefix_hits} hits, "
           f"{rep_x.prefix_hit_tokens} hit tokens")
    expect(launched_only(launches_x, ("flash_attention_quantized",
                                      "paged_decode_attention_quantized"))
           and on_path(paths_x, ("flash_attention_quantized",
                                 "paged_decode_attention_quantized"), "mma"),
           f"int8 prefix run: launches {launches_x}, by path {paths_x}")
    say("5 full-width int8-KV shared prefix", prefix_hits=rep_x.prefix_hits,
        prefix_hit_tokens=rep_x.prefix_hit_tokens,
        prefill_tokens=rep_x.prefill_tokens, wall_s=f"{rep_x.wall_s:.3f}",
        launches_flash_quantized=launches_x["flash_attention_quantized"])
    del eng_x

    # an int8 cache's first-token logits (a 512-wide prefill through K10)
    # against a bf16 cache's (K1), same weights, same 512-token prompt
    toks = np.zeros((1, 512), np.int32)
    toks[0] = np.random.RandomState(SEED + 2).randint(0, cfg.vocab_size, 512)
    batch = {"tokens": toks, "lengths": np.array([512], np.int32)}
    wide, _ = model.prefill_padded(params, batch, 1024, torch.bfloat16)
    narrow, _ = model.prefill_padded(params, batch, 1024, torch.int8)
    scale = wide.abs().max().item()
    rel = max_err(narrow, wide) / scale
    expect(np.isfinite(rel) and rel <= INT8_KV_LOGIT_REL_TOL,
           f"int8-KV first-token logits: rel err {rel} against bf16-KV")
    say("5 int8-KV vs bf16-KV first-token logits (K10 vs K1)",
        max_abs_err=f"{max_err(narrow, wide):.3g}",
        max_abs_logit=f"{scale:.3g}", rel_err=f"{rel:.3g}",
        bound=INT8_KV_LOGIT_REL_TOL,
        argmax_equal=bool(narrow.argmax() == wide.argmax()))
    del eng_c, tick_cache
    torch.cuda.empty_cache()
    return {"launches_int8": launches_c, "launches_int8_paged": launches_p,
            "paths_int8": paths_c, "outs_int8": outs_c, "rep_int8": rep_c}


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


# ----------------------------------------------------------------- phase 5s

SPEC_K = 4               # draft span of phase 5s's speculative serves


def spec_caches(model, params, prompts, kv_dtype, ps=PAGE_SIZE):
    """Two equal serve-form caches (contiguous, and its copy in a page
    pool at a seeded placement) after a pad-masked prefill of ``prompts``,
    8 rows at max_len 1024.  Row r owns ``ceil((len + SPEC_K + 1) / ps)``
    pages; its table entries past them stay 0 (scratch)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), int(lens.max())), np.int32)
    for r, p in enumerate(prompts):
        toks[r, : len(p)] = p
    _, cache = model.prefill_padded(params, {"tokens": toks, "lengths": lens},
                                    1024, kv_dtype)
    per_seq = 1024 // ps
    pool = model.init_paged_cache(len(prompts), 1024, len(prompts) * per_seq,
                                  ps, kv_dtype)
    spec = model.cache_page_spec(dtype=kv_dtype)
    order = np.random.RandomState(SEED + 5).permutation(
        len(prompts) * per_seq) + 1
    for row, length in enumerate(lens):
        used = -(-(int(length) + SPEC_K + 1) // ps)
        pages = order[row * per_seq: row * per_seq + used]
        single = {key: leaf[:, row:row + 1] for key, leaf in cache.items()
                  if key != "len"}
        model.write_page(pool, single, list(pages), list(range(used)),
                         spec=spec, page_size=ps)
        pool["pt"][:, row, :used] = torch.from_numpy(
            pages.astype(np.int32)).cuda()
        pool["len"][:, row] = int(length)
    return cache, pool, lens


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def check_verify_bits(model, params, prompts, fa, da) -> dict:
    """``verify_step``'s logits at every position against the
    ``decode_step`` that consumes the same tokens, bit for bit, at full
    width on 8 of phase 5's prompts (contiguous and paged caches); each
    verify launches K2 (K3) once a position and layer on the tensor
    cores.  Then one verify step profiled beside ``SPEC_K + 1`` ticks."""
    block = np.random.RandomState(SEED + 6).randint(
        0, model.cfg.vocab_size, (8, SPEC_K + 1)).astype(np.int32)
    contiguous, pool, lens = spec_caches(model, params, prompts[:8],
                                         torch.bfloat16)
    out = {}
    for name, cache, fn in (("contiguous", contiguous, "decode_attention"),
                            ("paged", pool, "paged_decode_attention")):
        ticks = clone_tree(cache)
        torch.cuda.synchronize()
        reset_counts(fa, da)
        vlogits, after_verify = model.verify_step(params, block, cache)
        torch.cuda.synchronize()
        launches, paths = read_counts(fa, da), read_paths(fa, da)
        expect(launched_only(launches, (fn,))
               and paths.get(fn) == {"mma": (SPEC_K + 1) * model.cfg.n_layers},
               f"{name} verify: launches {launches}, by path {paths}")
        equal = []
        after_ticks = ticks
        for j in range(SPEC_K + 1):
            dlogits, after_ticks = model.decode_step(
                params, block[:, j:j + 1], after_ticks)
            equal.append(bool(torch.equal(vlogits[:, j], dlogits)))
        same_cache = all(torch.equal(after_verify[k], after_ticks[k])
                         for k in after_verify)
        expect(all(equal) and same_cache,
               f"{name} verify vs ticks: logits equal by position {equal}, "
               f"caches equal {same_cache}")
        say(f"5s verify logits vs {SPEC_K + 1} ticks ({name}, full width)",
            positions=SPEC_K + 1, bit_equal=True, caches_equal=True,
            launches=launches[fn], path="mma",
            kv_lens=f"{lens.min()}-{lens.max()}")
        reset = torch.as_tensor(lens)

        def verify():
            model.override_cache_lengths(cache, reset)
            return model.verify_step(params, block, cache)

        def k_ticks():
            c = model.override_cache_lengths(ticks, reset)
            for j in range(SPEC_K + 1):
                _, c = model.decode_step(params, block[:, j:j + 1], c)

        out[name] = (profile(verify, 5), profile(k_ticks, 5))
        say(f"5s profile verify step ({name}, 8 slots, k={SPEC_K})",
            **out[name][0])
        say(f"5s profile {SPEC_K + 1} decode ticks ({name}, 8 slots)",
            **out[name][1])
        del ticks, after_ticks, after_verify
    del contiguous, pool
    torch.cuda.empty_cache()
    return out


def serve_speculative(cfg, model, params, Engine, ServeConfig, base, paged,
                      prompts, greedy, greedy_int8, fa, da) -> dict:
    """Phase 5s: speculative serve at ``SPEC_K`` on phase 5's requests,
    held to phase 5's greedy tokens bit for bit: the self drafter (the
    target itself) contiguous and paged, a cold drafter (2 layers of the
    same widths, seed 1) contiguous, and the self drafter over an int8
    cache (held to the int8 greedy tokens); ``greedy`` and
    ``greedy_int8`` are (tokens, report) of phase 5's greedy runs on the
    bf16 and the int8 cache.  The self drafter must accept
    every proposal the budget does not cut.  Launches by path: the
    target's verify runs K2 (K3 paged, K7 int8) once a position and layer,
    the drafter's contiguous cache K2 (K7) once a layer and step, the
    prefills K1 (K10), all on the tensor cores."""
    from repro_torch.serve import SpecConfig

    check_verify_bits(model, params, prompts, fa, da)
    cold = type(model)(dataclasses.replace(cfg, n_layers=2), device="cuda")
    cold_params = cold.init(SEED + 1)
    n_new = 32
    span_ticks = -(-(n_new - 1) // (SPEC_K + 1))     # per request
    runs = (("self drafter", base, greedy, model, params,
             ("flash_attention", "decode_attention"), "decode_attention"),
            ("self drafter, paged", dict(paged, prefix_cache=False), greedy,
             model, params, ("flash_attention", "paged_decode_attention",
                             "decode_attention"), "paged_decode_attention"),
            ("cold drafter", base, greedy, cold, cold_params,
             ("flash_attention", "decode_attention"), "decode_attention"),
            ("self drafter, int8 cache", dict(base, kv_dtype="int8"),
             greedy_int8, model, params, ("flash_attention_quantized",
                                        "decode_attention_quantized"),
             "decode_attention_quantized"))
    result = {}
    for name, kw, (want, want_rep), draft, dparams, names, fn in runs:
        eng = Engine(model, params, ServeConfig(**kw, spec=SpecConfig(
            draft=draft, draft_params=dparams, k=SPEC_K)))
        eng.serve(prompts[:2], 2)                     # warm-up
        got, launches = drive(eng, prompts, fa, da)
        paths = read_paths(fa, da)
        rep = eng.last_report
        expect(all(same_tokens(want, got)),
               f"speculative serve ({name}): tokens differ from greedy")
        expect(launched_only(launches, names)
               and on_path(paths, names, "mma"),
               f"speculative serve ({name}): launches {launches}, by path "
               f"{paths}")
        layers, dlayers = cfg.n_layers, draft.cfg.n_layers
        if fn == "paged_decode_attention":
            # the drafter keeps a contiguous cache, as the reference's
            expect(launches[fn] == rep.total_ticks * (SPEC_K + 1)
                   * layers
                   and launches["decode_attention"] % dlayers == 0
                   and SPEC_K * rep.total_ticks <= launches[
                       "decode_attention"] // dlayers
                   <= (SPEC_K + 1) * rep.total_ticks,
                   f"speculative serve ({name}): {launches} in "
                   f"{rep.total_ticks} ticks")
        if name.startswith("self"):
            expect(rep.decode_slot_ticks == span_ticks * len(prompts)
                   and rep.accepted_tokens
                   == (n_new - 1 - span_ticks) * len(prompts),
                   f"{name}: {rep.accepted_tokens} accepted "
                   f"in {rep.decode_slot_ticks} slot ticks")
        result[name] = launches
        say(f"5s full-width speculative serve ({name}, k={SPEC_K})",
            tokens_equal_greedy=True, tokens=rep.total_tokens,
            ticks=rep.total_ticks, greedy_ticks=want_rep.total_ticks,
            decode_slot_ticks=rep.decode_slot_ticks,
            greedy_decode_slot_ticks=want_rep.decode_slot_ticks,
            drafted=rep.drafted_tokens, accepted=rep.accepted_tokens,
            acceptance_rate=f"{rep.acceptance_rate:.4f}",
            faa_per_token=f"{rep.faa_per_token:.4f}",
            greedy_faa_per_token=f"{want_rep.faa_per_token:.4f}",
            wall_s=f"{rep.wall_s:.3f}",
            greedy_wall_s=f"{want_rep.wall_s:.3f}",
            tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
            greedy_tokens_per_s=(
                f"{want_rep.total_tokens / want_rep.wall_s:.1f}"),
            **{f"{fn}_per_tick": f"{launches[fn] / rep.total_ticks:.1f}"},
            **{f"launches_{n}": launches[n] for n in names})
        del eng
    del cold, cold_params
    torch.cuda.empty_cache()
    return {"launches_spec": result["self drafter"],
            "launches_spec_paged": result["self drafter, paged"],
            "launches_spec_int8": result["self drafter, int8 cache"]}


# ----------------------------------------------------------------- phase 5f

def serve_faulted(model, params, Engine, ServeConfig, base, prompts, outs,
                  fa, da) -> None:
    """Phase 5f: degradation at full width on phase 5's requests,
    contiguous.  One request poisoned at admission, one at decode step 4,
    a decode stall on two ticks: exactly those two requests end FAILED,
    the other 14 give phase 5's tokens, and the stall is charged.  Then a
    self-drafter run with a draft-poisoned request: phase 5's tokens, the
    poisoned ticks degraded, no request failed."""
    from repro_torch.core import faults
    from repro_torch.serve import SpecConfig

    admit, decode, drafted = 3, 9, 5
    plan = faults.FaultPlan(seed=SEED, specs=(
        faults.PoisonRequest(rids=(admit,)),
        faults.PoisonRequest(rids=(decode,), site="decode", steps=(4,)),
        faults.DecodeStall(ticks=(2, 5), duration_s=0.01)))
    eng = Engine(model, params, ServeConfig(**base))
    with faults.fault_scope(plan):
        got, launches = drive(eng, prompts, fa, da)
    rep = eng.last_report
    failed = sorted(t.rid for t in rep.requests if t.status == "failed")
    survivors = [r for r in range(len(prompts)) if r not in (admit, decode)]
    expect(failed == sorted((admit, decode))
           and all(np.array_equal(got[r], outs[r]) for r in survivors)
           and (got[admit] == -1).all() and (got[decode] == -1).all()
           and rep.injected_stall_s > 0
           and launched_only(launches, ("flash_attention",
                                        "decode_attention")),
           f"faulted serve: failed {failed}, stall {rep.injected_stall_s}, "
           f"launches {launches}")
    say("5f full-width faulted serve (contiguous)", failed=failed,
        reasons="|".join(t.fail_reason.split(":")[0] for t in rep.requests
                         if t.status == "failed"),
        survivors_equal_greedy=len(survivors), ok=rep.ok_requests,
        injected_stall_s=f"{rep.injected_stall_s:.3f}",
        ticks=rep.total_ticks, wall_s=f"{rep.wall_s:.3f}")
    plan = faults.FaultPlan(seed=SEED, specs=(
        faults.PoisonRequest(rids=(drafted,), site="draft"),))
    eng = Engine(model, params, ServeConfig(**base, spec=SpecConfig(
        draft=model, draft_params=params, k=SPEC_K)))
    with faults.fault_scope(plan):
        got, launches = drive(eng, prompts, fa, da)
    rep = eng.last_report
    expect(all(same_tokens(outs, got)) and rep.draft_degraded_ticks > 0
           and rep.failed_requests == 0 and rep.shed_requests == 0,
           f"draft-poisoned speculative serve: degraded "
           f"{rep.draft_degraded_ticks}, failed {rep.failed_requests}")
    say("5f full-width draft-poisoned speculative serve (self drafter)",
        tokens_equal_greedy=True,
        draft_degraded_ticks=rep.draft_degraded_ticks,
        failed=rep.failed_requests, ticks=rep.total_ticks,
        accepted=rep.accepted_tokens, drafted=rep.drafted_tokens,
        wall_s=f"{rep.wall_s:.3f}")
    del eng
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 5t

def pinned_db(depth: int):
    """A tuning db whose every bucket holds ring depth ``depth``, the split
    count left at the classic pick: every attention op of a serve then
    runs its pipelined kernel at that depth (fitted to shared memory)."""
    from repro_torch.core import autotune_search

    class PinnedDB(autotune_search.TuningDB):
        def lookup(self, kernel, backend, bucket):
            return {"num_buffers": depth}

    return PinnedDB()


def serve_tuned_path(cfg, model, params, Engine, ServeConfig, base, paged,
                     prompts, outs, outs_int8, tick_fn, fa, da) -> dict:
    """The tuned path at full width, on phase 5's requests: the measured
    search for the main-path buckets into a db under build/ (the tune
    table printed); serves with dbs pinned to depth 2 and 4 on the
    contiguous (K4, K5), paged (K4, K6) and int8 paged (K10, K9) caches,
    tokens equal to phase 5's classic runs and no classic attention kernel
    launched; the same serves with the tuned db (configs picked, tokens/s,
    a profiled decode tick and 512-wide prefill); and
    ServeConfig(page_size=None) under the tuned db against a paged run at
    the page size it resolves.  No serve takes a timed measurement."""
    from repro_torch.core import autotune_search
    from repro_torch.launch import tune

    os.environ["REPRO_TUNING"] = "on"
    tuned = autotune_search.TuningDB.open(autotune_search.tuning_db_path())
    t0 = time.monotonic()
    results = tune.run(sorted(autotune_search.REPRESENTATIVE_SHAPES),
                       autotune_search.REPRESENTATIVE_SHAPES, db=tuned,
                       options=autotune_search.SearchOptions())
    say("5t tune", buckets=len(results), entries=len(tuned),
        search_s=f"{time.monotonic() - t0:.1f}",
        timed=sum(r.n_timed for r in results), db=tuned.path)
    q8 = dict(paged, kv_dtype="int8")
    runs = (("contiguous", base, outs,
             ("flash_attention_pipelined", "decode_attention_pipelined")),
            ("paged", paged, outs,
             ("flash_attention_pipelined",
              "paged_decode_attention_pipelined")),
            ("int8 paged", q8, outs_int8,
             ("flash_attention_quantized",
              "paged_decode_attention_quantized_pipelined")))
    pinned = {}
    for depth in (2, 4):
        autotune_search.set_db(pinned_db(depth))
        for name, sc, want, kernels in runs:
            eng = Engine(model, params, ServeConfig(**sc, prefix_cache=False))
            before = autotune_search.measurement_count()
            got, launches = drive(eng, prompts, fa, da)
            paths = read_paths(fa, da)
            rep = eng.last_report
            expect(autotune_search.measurement_count() == before,
                   f"pinned depth {depth} {name}: the serve measured")
            expect(all(same_tokens(want, got)),
                   f"pinned depth {depth} {name}: tokens differ from the "
                   f"classic run")
            expect(launched_only(launches, kernels)
                   and on_path(paths, kernels, "mma"),
                   f"pinned depth {depth} {name}: launches {launches}, by "
                   f"path {paths}")
            pinned[(depth, name)] = launches
            say(f"5t pinned depth {depth} {name} serve",
                tokens_equal_classic=True, tokens=rep.total_tokens,
                tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
                **{f"launches_{k}": launches[k] for k in kernels})
            del eng

    autotune_search.set_db(tuned)
    hd = cfg.resolved_head_dim
    rows = 8 * cfg.n_kv_heads
    picked = {
        "flash_w512": autotune_search.lookup_or_search(
            "flash_attention", sq=512, skv=1024, d=hd, dv=hd,
            dtype="bfloat16", causal=True),
        "decode": autotune_search.lookup_or_search(
            "decode_attention", s=1024, d=hd, dv=hd, dtype="bfloat16",
            rows=rows),
        "paged": autotune_search.lookup_or_search(
            "paged_decode_attention", s=1024, page_size=PAGE_SIZE, d=hd,
            dv=hd, dtype="bfloat16", rows=rows),
        "paged_int8": autotune_search.lookup_or_search(
            "paged_decode_attention", s=1024, page_size=PAGE_SIZE, d=hd,
            dv=hd, dtype="int8", rows=rows),
        "open": autotune_search.lookup_or_search(
            "paged_decode_attention", s=1024, page_size=0, d=hd, dv=hd,
            dtype="bfloat16", rows=rows)}
    classic_splits = da.num_splits(8, cfg.n_kv_heads, 1024,
                                   torch.cuda.get_device_properties(
                                       0).multi_processor_count)
    say("5t tuned configs", classic_splits=classic_splits,
        **{k: autotune_search.fmt_items(v) for k, v in picked.items()})
    tuned_runs = {}
    for name, sc, want, _ in runs:
        eng = Engine(model, params, ServeConfig(**sc, prefix_cache=False))
        before = autotune_search.measurement_count()
        got, launches = drive(eng, prompts, fa, da)
        rep = eng.last_report
        expect(autotune_search.measurement_count() == before,
               f"tuned {name}: the serve measured")
        equal = same_tokens(want, got)
        # only the contiguous decode's split count may move the sums
        if name != "contiguous" or picked["decode"].get(
                "num_splits", classic_splits) == classic_splits:
            expect(all(equal), f"tuned {name}: tokens differ from classic")
        tuned_runs[name] = rep.total_tokens / rep.wall_s
        say(f"5t tuned {name} serve",
            share_equal_classic=f"{np.mean(equal):.3f}",
            tokens=rep.total_tokens, ticks=rep.total_ticks,
            wall_s=f"{rep.wall_s:.3f}",
            tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
            **{f"launches_{k}": n for k, n in launches.items() if n})
        if name == "contiguous":
            toks = np.zeros((1, 512), np.int32)
            toks[0] = np.random.RandomState(SEED + 3).randint(
                0, cfg.vocab_size, 512)
            say("5t profile tuned decode tick (8 slots)",
                **profile(tick_fn, 10))
            say("5t profile tuned prefill (width 512)",
                **profile(lambda: eng._prefill_padded(
                    params, toks, np.array([512], np.int32)), 5))
        del eng

    open_cfg = dict(base, cache="paged", page_size=None, prefix_cache=False)
    eng = Engine(model, params, ServeConfig(**open_cfg))
    before = autotune_search.measurement_count()
    got, _ = drive(eng, prompts, fa, da)
    ps = eng._backend.ps
    fixed = Engine(model, params, ServeConfig(**dict(open_cfg,
                                                     page_size=ps)))
    want, _ = drive(fixed, prompts, fa, da)
    expect(autotune_search.measurement_count() == before,
           "page_size=None: the serve measured")
    expect(all(same_tokens(want, got)),
           f"page_size=None: tokens differ from a paged run at {ps}")
    rep = eng.last_report
    say("5t page_size=None serve", resolved_page_size=ps,
        tokens_equal_explicit=True,
        share_equal_classic=f"{np.mean(same_tokens(outs, got)):.3f}",
        tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}")
    del eng, fixed
    autotune_search.set_db(autotune_search.TuningDB())
    os.environ["REPRO_TUNING"] = "off"
    return {"launches_pinned": pinned[(2, "contiguous")],
            "launches_pinned_paged": pinned[(2, "paged")],
            "launches_pinned_int8": pinned[(2, "int8 paged")],
            "tuned_configs": picked, "tune_results": results}


# ----------------------------------------------------------------- phase 5c

def serve_ssm_full_width(get_config, Model, Engine, ServeConfig, fa, da, ss,
                         quant) -> dict:
    """Full-width mamba2-780m in bf16 (weights from the seed) serving the
    16 requests of phase 5 (25-488 prompt tokens) through 8 slots, 32 new
    tokens each: contiguous, then paged with tokens equal and no page
    allocated; every multi-token prompt prefilled through K12 (48 scans)
    and no attention kernel launched.  Then a profiled 488-token prefill
    and decode tick, and K13 through its op on that prefill's
    activations."""
    gc.collect()
    cfg = get_config("mamba2-780m").with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    t0 = time.monotonic()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 513, 16)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    multi = int(sum(n > 1 for n in lens))
    base = dict(max_len=1024, slots=8, refill_schedule="faa",
                cache_dtype="bfloat16")
    eng = Engine(model, params, ServeConfig(**base))
    eng.serve(prompts[:2], 2)                     # warm-up (cuBLAS)
    outs, launches = drive(eng, prompts, fa, da)
    paths = read_paths(fa, da)
    rep = eng.last_report
    expect(launched_only(launches, ("ssd",))
           and launches["ssd"] == cfg.n_layers * multi
           and paths.get("ssd") == {"mma": launches["ssd"]},
           f"mamba2 contiguous serve: launches {launches}, by path {paths}, "
           f"want {cfg.n_layers * multi} of K12 alone on the tensor cores")
    expect(len(outs) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs), "mamba2 serve: malformed outputs")
    eng_p = Engine(model, params, ServeConfig(**base, cache="paged",
                                              page_size=PAGE_SIZE))
    eng_p.serve(prompts[:2], 2)                   # warm-up
    outs_p, launches_p = drive(eng_p, prompts, fa, da)
    paths_p = read_paths(fa, da)
    rep_p = eng_p.last_report
    expect(all(same_tokens(outs, outs_p)),
           "mamba2 paged serve: tokens differ from the contiguous run")
    expect(rep_p.pages_allocated == rep_p.peak_pages_live == 0
           and launches_p == launches and paths_p == paths,
           f"mamba2 paged serve: {rep_p.pages_allocated} pages, launches "
           f"{launches_p}, by path {paths_p}")
    del eng_p
    longest = prompts[int(np.argmax(lens))][None, :]

    def prefill():
        return model.prefill(params, {"tokens": longest}, base["max_len"])

    logits, _ = prefill()
    expect(bool(torch.isfinite(logits).all()), "mamba2 prefill: logits not "
           "finite")
    pre = profile(prefill, 5)
    say(f"5c profile mamba2 prefill ({longest.shape[1]} tokens)", **pre)
    tick = np.zeros((8, 1), np.int32)
    tick_cache = eng._backend.cache
    decode = profile(lambda: model.decode_step(params, tick, tick_cache), 10)
    say("5c profile mamba2 decode tick (8 slots)", **decode)
    result = dict(
        requests=len(prompts), prompt_lens=f"{lens.min()}-{lens.max()}",
        tokens=rep.total_tokens, ticks=rep.total_ticks,
        wall_s=f"{rep.wall_s:.3f}",
        tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
        paged_wall_s=f"{rep_p.wall_s:.3f}",
        paged_tokens_per_s=f"{rep_p.total_tokens / rep_p.wall_s:.1f}",
        tokens_equal_paged=True, pages_allocated=rep_p.pages_allocated,
        prefill_wall_ms=pre["wall_ms"],
        prefill_device_ms=pre.get("device_ms"),
        decode_tick_wall_ms=decode["wall_ms"],
        decode_tick_device_ms=decode.get("device_ms"),
        init_s=f"{init_s:.1f}", launches_ssd=launches["ssd"],
        ssd_paths=paths["ssd"])
    say("5c full-width bf16 mamba2 serve", **result)
    launches_k13 = k13_through_op(model, params, longest, ss, quant, fa, da)
    del eng, tick_cache, params, model
    torch.cuda.empty_cache()
    return {"launches_ssm": launches, "launches_k13": launches_k13}


def k13_through_op(model, params, toks, ss, quant, fa, da) -> dict:
    """K13 on the main path's activations: one prefill of ``toks`` in
    which every layer's scan inputs (x, dt, a, B, C, taken where the
    model's ``ssd_chunked`` calls K12) also go through ``ssd_quantized``
    with x quantized to int8 per (token, head).  K13's y is held to K12's
    within ``K13_PATH_REL_TOL`` of max |y|."""
    from repro_torch.models import ssm as ssm_mod

    real = ssm_mod.ssd_chunked
    errs = []

    def both(x, dt, a, b_in, c_in, **kw):
        y, st = real(x, dt, a, b_in, c_in, **kw)
        xq, xs = quantized(quant, x.contiguous(), torch.int8)
        yq, _ = ss.ssd_quantized(xq, xs, dt.contiguous(), a.contiguous(),
                                 b_in.contiguous(), c_in.contiguous())
        errs.append(rel_err(yq, y) if bool(torch.isfinite(yq).all())
                    else float("inf"))
        return y, st

    torch.cuda.synchronize()
    reset_counts(fa, da)
    ssm_mod.ssd_chunked = both
    try:
        model.prefill(params, {"tokens": toks}, 1024)
    finally:
        ssm_mod.ssd_chunked = real
    torch.cuda.synchronize()
    launches, paths = read_counts(fa, da), read_paths(fa, da)
    n = model.cfg.n_layers
    expect(launched_only(launches, ("ssd", "ssd_quantized"))
           and launches["ssd"] == launches["ssd_quantized"] == n
           and paths.get("ssd_quantized") == {"mma": n}
           and max(errs) <= K13_PATH_REL_TOL,
           f"K13 through its op: launches {launches}, by path {paths}, "
           f"relative errors {max(errs)}")
    say("5c K13 through its op (int8 x, every layer of the prefill)",
        tokens=toks.shape[1], launches_ssd_quantized=n,
        y_rel_err_vs_k12_max=f"{max(errs):.3g}",
        y_rel_err_vs_k12_mean=f"{float(np.mean(errs)):.3g}")
    return launches


# ------------------------------------------------------- phases 4h and 5h

def check_reduced_hybrid(get_config, Model, Engine, ServeConfig, fa,
                         da) -> None:
    """The reduced f32 zamba2-2.7b at the full model's head shape (head
    dim 80, 4 query heads on 4 KV heads) on the card (K12, K1, K2, K3)
    against the CPU (the plain versions): first-token logits and every
    cache leaf of a 100-token prefill, 3 decode steps, then greedy serve on
    the contiguous and the paged cache, tokens equal to the CPU's and
    paged equal to contiguous, K12 launched once per SSD layer of every
    multi-token prompt, K1 once per group of every prompt (a one-token
    prompt's SSD layers take the decode step, its attention K1)."""
    cfg = dataclasses.replace(get_config(HYBRID_ARCH).reduced(),
                              head_dim=D80, n_heads=4, n_kv_heads=4)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED)
    toks = rng.randint(1, cfg.vocab_size, (2, 100)).astype(np.int32)
    errs = reduced_card_vs_cpu(cpu, gpu, params_cpu, params_gpu,
                               {"tokens": toks}, {"tokens": toks}, 256, rng,
                               fa, da)
    prefill_err, decode_err, cache_err = (errs["prefill"], errs["decode"],
                                          errs["cache"])
    expect(prefill_err <= LOGIT_TOL and decode_err <= LOGIT_TOL
           and cache_err <= LOGIT_TOL,
           f"reduced zamba2: prefill {prefill_err}, decode {decode_err}, "
           f"cache {cache_err}")
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 5, 37, 64, 100, 130, 17, 200, 3, 66)]
    multi = sum(len(p) > 1 for p in prompts)
    groups = cfg.n_layers // cfg.attn_every
    fields, outs = {}, {}
    for cache in ("contiguous", "paged"):
        scfg = ServeConfig(max_len=256, slots=3, refill_schedule="faa",
                           cache=cache, page_size=PAGE_SIZE)
        out_cpu = Engine(cpu, params_cpu, scfg).serve(prompts, 12)
        eng = Engine(gpu, params_gpu, scfg)
        outs[cache], launches = drive(eng, prompts, fa, da, n_new=12)
        decode = ("paged_decode_attention" if cache == "paged"
                  else "decode_attention")
        same = all(same_tokens(out_cpu, outs[cache]))
        expect(same and launched_only(launches, ("ssd", "flash_attention",
                                                 decode))
               and launches["ssd"] == cfg.n_layers * multi
               and launches["flash_attention"] == groups * len(prompts)
               and launches[decode] == groups * eng.last_report.total_ticks,
               f"reduced zamba2 {cache} serve: tokens equal {same}, "
               f"launches {launches}")
        fields[f"{cache}_tokens_equal_cpu"] = same
        fields[f"{cache}_launches"] = ",".join(
            f"{n}:{c}" for n, c in launches.items() if c)
    expect(all(same_tokens(outs["contiguous"], outs["paged"])),
           "reduced zamba2: paged tokens differ from contiguous")
    say("4h reduced f32 zamba2 (head_dim 80, G = 1) card vs cpu",
        prefill_logit_err=f"{prefill_err:.3g}",
        decode_logit_err=f"{decode_err:.3g}",
        cache_rel_err=f"{cache_err:.3g}", requests=len(prompts),
        multi_token_prompts=multi, paged_equals_contiguous=True, **fields)


def serve_hybrid_full_width(get_config, Model, Engine, ServeConfig,
                            fa, da) -> dict:
    """Full-width zamba2-2.7b in bf16 (weights from the seed: 54 SSD layers
    in 9 groups, one shared attention block of 32 heads of 80) serving the
    16 requests of phase 5's lengths through 8 slots, 32 new tokens each:
    contiguous (K12 54 times, K1 9 times per prompt, K2 9 times a tick),
    paged (K3 in K2's place, tokens equal to contiguous, pages allocated
    for the attention leaves), int8 contiguous (K10, K7) and int8 paged
    (K10, K8; tokens equal to int8 contiguous), every launch on the tensor
    cores; a profiled 488-token prefill and decode tick on each cache, and
    the launches by path."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID_ARCH).with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_gb = (torch.cuda.memory_allocated() - before) / 1e9
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 513, 16)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    groups = cfg.n_layers // cfg.attn_every
    base = dict(max_len=1024, slots=8, refill_schedule="faa",
                cache_dtype="bfloat16")
    runs = {"bf16": (base, "flash_attention", "decode_attention"),
            "bf16_paged": (dict(base, cache="paged", page_size=PAGE_SIZE),
                           "flash_attention", "paged_decode_attention"),
            "int8": (dict(base, kv_dtype="int8"),
                     "flash_attention_quantized",
                     "decode_attention_quantized"),
            "int8_paged": (dict(base, kv_dtype="int8", cache="paged",
                                page_size=PAGE_SIZE),
                           "flash_attention_quantized",
                           "paged_decode_attention_quantized")}
    outs, launches_by, fields, engines = {}, {}, {}, {}
    longest = prompts[int(np.argmax(lens))]
    for key, (scfg, prefill_k, decode_k) in runs.items():
        eng = Engine(model, params, ServeConfig(**scfg))
        eng.serve(prompts[:2], 2)                 # warm-up (cuBLAS, caches)
        outs[key], launches = drive(eng, prompts, fa, da)
        paths = read_paths(fa, da)
        rep = eng.last_report
        want = {"ssd": cfg.n_layers * len(prompts),
                prefill_k: groups * len(prompts),
                decode_k: groups * rep.total_ticks}
        expect({n: c for n, c in launches.items() if c} == want
               and on_path(paths, want, "mma"),
               f"zamba2 {key} serve: launches {launches} (want {want}), "
               f"by path {paths}")
        expect(len(outs[key]) == 16 and all(
            o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
            for o in outs[key]), f"zamba2 {key} serve: malformed outputs")
        launches_by[key] = launches
        fields[f"{key}_tokens_per_s"] = f"{rep.total_tokens / rep.wall_s:.1f}"
        fields[f"{key}_ticks"] = rep.total_ticks
        if "paged" in key:
            twin = key.replace("_paged", "")
            expect(all(same_tokens(outs[twin], outs[key]))
                   and rep.pages_allocated > 0,
                   f"zamba2 {key} serve: tokens differ from {twin}, or "
                   f"{rep.pages_allocated} pages")
            fields[f"{key}_tokens_equal_{twin}"] = True
            fields[f"{key}_pages_allocated"] = rep.pages_allocated
        engines[key] = eng
        say(f"5h full-width bf16 zamba2 serve ({key})",
            tokens=rep.total_tokens, ticks=rep.total_ticks,
            wall_s=f"{rep.wall_s:.3f}",
            tokens_per_s=fields[f"{key}_tokens_per_s"],
            **{f"launches_{n}": c for n, c in launches.items() if c},
            paths=";".join(f"{n}:{'/'.join(p)}" for n, p in paths.items()))
    # profiled phases, outside the counted runs: the longest prompt's
    # prefill (exact length) and one decode tick of the 8-slot batch on
    # each cache (the paged tick at the contiguous tick's lengths)
    tick = np.zeros((8, 1), np.int32)
    prof = {}
    for key in ("bf16", "int8"):
        kvd = torch.int8 if key == "int8" else torch.bfloat16

        def prefill():
            return model.prefill(params, {"tokens": longest[None, :]},
                                 base["max_len"], kvd)

        logits, _ = prefill()
        expect(bool(torch.isfinite(logits).all()),
               f"zamba2 {key} prefill: logits not finite")
        prof[f"{key}_prefill"] = profile(prefill, 5)
        cache = engines[key]._backend.cache
        prof[f"{key}_tick"] = profile(
            lambda: model.decode_step(params, tick, cache), 10)
    pool = engines["bf16_paged"]._backend.cache["attn"]
    table = torch.arange(1, 513, dtype=torch.int32, device="cuda").reshape(
        8, 64).expand(groups, 8, 64).contiguous()
    contiguous = engines["bf16"]._backend.cache
    paged_tick = {"ssm": engines["bf16_paged"]._backend.cache["ssm"],
                  "attn": {"k": pool["k"], "v": pool["v"], "pt": table,
                           "len": contiguous["attn"]["len"].clone()}}
    prof["bf16_paged_tick"] = profile(
        lambda: model.decode_step(params, tick, paged_tick), 10)
    for key, p in prof.items():
        what = (f"prefill ({len(longest)} tokens)" if key.endswith("prefill")
                else "decode tick (8 slots)")
        say(f"5h profile zamba2 {key.rsplit('_', 1)[0]} {what}", **p)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    result = dict(
        weights_gb=f"{weights_gb:.2f}", init_s=f"{init_s:.1f}",
        requests=len(prompts), prompt_lens=f"{lens.min()}-{lens.max()}",
        peak_gb=f"{peak_gb:.2f}", **fields,
        prefill_wall_ms=prof["bf16_prefill"]["wall_ms"],
        prefill_device_ms=prof["bf16_prefill"].get("device_ms"),
        tick_wall_ms=prof["bf16_tick"]["wall_ms"],
        tick_device_ms=prof["bf16_tick"].get("device_ms"))
    say("5h full-width bf16 zamba2 serve", **result)
    del engines, pool, paged_tick, contiguous, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_hybrid": launches_by["bf16"],
            "launches_hybrid_paged": launches_by["bf16_paged"],
            "launches_hybrid_int8": launches_by["int8"],
            "launches_hybrid_int8_paged": launches_by["int8_paged"],
            "hybrid_serve_lens": lens}


# ----------------------------------------------------------------- phase 5r

SAMPLE_TEMP = 0.8        # phase 5r's temperature


def check_reduced_sampled(get_config, Model, Engine, ServeConfig) -> None:
    """Phase 4r: the reduced f32 qwen2.5-3b at temperature ``SAMPLE_TEMP``
    on the card (the sampler on the device) against the CPU: the
    continuous serve's tokens equal the CPU's; on the card the rounds
    serve and each request's ``generate(rids=[rid])`` equal it.  In f32
    the card's logits differ from the CPU's in summation order only, so a
    draw could move only at a near tie of two gumbel-perturbed logits."""
    cfg = get_config("qwen2.5-3b").reduced()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(3, 40, 10)]
    scfg = ServeConfig(max_len=64, slots=4, refill_schedule="faa",
                       temperature=SAMPLE_TEMP)
    want = Engine(cpu, params_cpu, scfg).serve(prompts, 12, seed=5)
    eng = Engine(gpu, params_gpu, scfg)
    got = eng.serve(prompts, 12, seed=5)
    rounds = Engine(gpu, params_gpu, dataclasses.replace(
        scfg, slots=3, mode="rounds")).serve(prompts, 12, seed=5)
    solo = [eng.generate({"tokens": p[None, :]}, 12, seed=5, rids=[rid])[0]
            for rid, p in enumerate(prompts)]
    expect(all(same_tokens(want, got)) and all(same_tokens(got, rounds))
           and all(same_tokens(got, solo)),
           "reduced temperature serve: card tokens differ from the CPU's, "
           "or rounds / generate differ from continuous on the card")
    say("4r reduced f32 temperature serve card vs cpu",
        temperature=SAMPLE_TEMP, requests=len(prompts),
        tokens_equal_cpu=True, rounds_equal=True, generate_equal=True)


def rounds_witness(eng_r8, params, prompts, outs, outs_r8) -> dict:
    """Why 8-slot rounds may sample other tokens than continuous, shown
    bit for bit.  A rounds cohort is one pad-masked prefill of its 8
    prompts at the widest one's bucket; continuous admits each prompt
    alone at its own bucket.  Every later tick is an [8, 1] decode step in
    both modes, whose products are row by row the same (the same shapes;
    K2's split plan follows the cache's shape, not the lengths), and each
    row draws from its own (seed, rid, step) stream.  So (1) a continuous
    serve whose admissions take their first-token logits and cache rows
    from the rounds cohorts' prefills must give the rounds tokens for
    every request, whatever slots, ticks and companions each request
    meets there; and (2) a request whose own one-request prefill (logits
    and every layer's K and V rows) is bit-equal to its cohort row must
    get equal tokens in the two plain runs.  Both are checked; the counts
    are returned for the 5r line."""
    from repro_torch.serve import paged_cache

    cfg, width = eng_r8.cfg, eng_r8._bucket_width
    expect(eng_r8.model.pad_safe_prefill,
           "rounds witness: cohorts of one length are not modelled here")
    axes = eng_r8.model.cache_batch_axes(dtype=eng_r8.kv_dtype)

    def row_of(cache, ax, j):
        return {key: (row_of(leaf, ax[key], j) if isinstance(leaf, dict)
                      else leaf.narrow(ax[key], j, 1) if ax[key] >= 0
                      else leaf) for key, leaf in cache.items()}

    cohort_rows, same_prefill = {}, []
    for c0 in range(0, len(prompts), cfg.slots):
        cohort = prompts[c0:c0 + cfg.slots]
        toks = np.zeros((cfg.slots, width(max(map(len, cohort)))), np.int32)
        lens = np.ones(cfg.slots, np.int32)
        for j, p in enumerate(cohort):
            toks[j, :len(p)], lens[j] = p, len(p)
        logits, cache = eng_r8._prefill_padded(params, toks, lens)
        for j, p in enumerate(cohort):
            cohort_rows[c0 + j] = (logits[j:j + 1], row_of(cache, axes, j))
            one = np.zeros((1, width(len(p))), np.int32)
            one[0, :len(p)] = p
            lg1, cache1 = eng_r8._prefill_padded(params, one,
                                                 np.asarray([len(p)]))
            same_prefill.append(torch.equal(logits[j], lg1[0]) and all(
                torch.equal(cache[key][:, j, :len(p)],
                            cache1[key][:, 0, :len(p)]) for key in ("k", "v")))
            del lg1, cache1
    real = paged_cache._prefill_request
    paged_cache._prefill_request = lambda eng, req: cohort_rows[req.rid]
    try:
        replayed = type(eng_r8)(eng_r8.model, params, dataclasses.replace(
            cfg, mode="continuous")).serve(prompts, len(outs_r8[0]))
    finally:
        paged_cache._prefill_request = real
    del cohort_rows
    torch.cuda.empty_cache()
    expect(all(same_tokens(replayed, outs_r8)),
           "temperature serve at 8 slots: continuous fed the rounds "
           "cohorts' prefills differs from rounds for requests "
           f"{[i for i, e in enumerate(same_tokens(replayed, outs_r8)) if not e]}")
    equal = same_tokens(outs, outs_r8)
    unexplained = [rid for rid, (pre, tok) in enumerate(
        zip(same_prefill, equal)) if pre and not tok]
    expect(not unexplained,
           f"temperature serve at 8 slots: requests {unexplained} have a "
           f"bit-equal prefill in rounds and continuous but other tokens")
    return {"rounds_8_replayed_from_cohort_prefills_equal": len(prompts),
            "rounds_8_requests_prefill_equal": sum(same_prefill),
            "rounds_8_requests_tokens_equal": sum(equal)}


def serve_sampled(model, params, Engine, ServeConfig, base, paged, prompts,
                  fa, da) -> None:
    """Phase 5r, on phase 5's model and requests at temperature
    ``SAMPLE_TEMP`` (seed 0).  Bit for bit where the card computes the same
    products: the continuous serve (8 slots) equals the serve under another
    admission policy (another admission order) and the paged serve; at one
    slot, where every prefill is one request at its bucket width and every
    tick one row, continuous equals rounds and each request's
    ``generate(rids=[rid])`` (8 requests, 16 tokens).  At 8 slots the
    rounds barrier prefills a cohort as one batch, whose bf16 products
    cuBLAS may round otherwise than a one-request prefill's: a request
    whose prefill is bit-equal both ways must get equal tokens
    (:func:`rounds_witness`), and the share of equal tokens is printed.  Then
    the sampler's device ms, launches and wall ms on one tick's [8, V]
    logits, and a profiled tick with its draw."""
    from repro_torch.serve import sampling

    sampled = dict(base, temperature=SAMPLE_TEMP)
    eng = Engine(model, params, ServeConfig(**sampled))
    eng.serve(prompts[:2], 2)                      # warm-up
    outs, launches = drive(eng, prompts, fa, da)
    rep = eng.last_report
    expect(launched_only(launches, ("flash_attention", "decode_attention")),
           f"temperature serve: launches {launches}")
    other = Engine(model, params, ServeConfig(**dict(
        sampled, refill_schedule="stealing"))).serve(prompts, 32)
    outs_p = Engine(model, params, ServeConfig(
        **dict(paged, temperature=SAMPLE_TEMP), prefix_cache=False)).serve(
            prompts, 32)
    expect(all(same_tokens(outs, other)) and all(same_tokens(outs, outs_p)),
           "temperature serve: another admission order or the paged cache "
           "changed the tokens")
    one = dict(sampled, slots=1)
    few = prompts[:8]
    eng1 = Engine(model, params, ServeConfig(**one))
    outs1 = eng1.serve(few, 16)
    eng_r = Engine(model, params, ServeConfig(**one, mode="rounds"))
    outs_r1, launches_r1 = drive(eng_r, few, fa, da, n_new=16)
    solo = []
    for rid, p in enumerate(few):
        toks = np.zeros((1, eng1._bucket_width(len(p))), np.int32)
        toks[0, :len(p)] = p
        solo.append(eng1.generate({"tokens": toks}, 16, rids=[rid],
                                  lengths=[len(p)])[0])
    expect(all(same_tokens(outs1, outs_r1)) and all(same_tokens(outs1, solo))
           and launched_only(launches_r1, ("flash_attention",
                                           "decode_attention")),
           f"temperature serve at one slot: rounds or generate differ from "
           f"continuous (launches {launches_r1})")
    eng_r8 = Engine(model, params, ServeConfig(**sampled, mode="rounds"))
    outs_r8 = eng_r8.serve(prompts, 32)
    rep_r8 = eng_r8.last_report
    equal_share = float(np.mean([np.mean(a == b)
                                 for a, b in zip(outs, outs_r8)]))
    witness = rounds_witness(eng_r8, params, prompts, outs, outs_r8)
    greedy = Engine(model, params, ServeConfig(**base)).serve(prompts[:4], 32)
    differs = sum(not np.array_equal(a, b) for a, b in zip(outs, greedy))
    logits = torch.randn((8, model.cfg.vocab_size), generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    rids = np.arange(8, dtype=np.int32)
    steps = np.full(8, 7, np.int32)

    def draw():
        return sampling.sample(logits, 0, rids, steps, SAMPLE_TEMP)

    draw_prof = profile(draw, 20)
    tick = np.zeros((8, 1), np.int32)
    cache = eng._backend.cache

    def sampled_tick():
        lg, _ = model.decode_step(params, tick, cache)
        return eng._pick(lg, 0, rids, steps)

    tick_prof = profile(sampled_tick, 10)
    say("5r profile sampler (one tick's [8, V] logits)", **draw_prof)
    say("5r profile decode tick with its draw (8 slots)", **tick_prof)
    say("5r full-width bf16 temperature serve", temperature=SAMPLE_TEMP,
        seed=0, other_policy_equal=True, paged_equal=True,
        one_slot_rounds_equal=True, one_slot_generate_equal=len(solo),
        rounds_8_slots_token_share_equal=f"{equal_share:.3f}",
        differs_from_greedy=f"{differs}/4", tokens=rep.total_tokens,
        ticks=rep.total_ticks, wall_s=f"{rep.wall_s:.3f}",
        tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
        rounds_ticks=rep_r8.total_ticks, rounds_wall_s=f"{rep_r8.wall_s:.3f}",
        rounds_tokens_per_s=f"{rep_r8.total_tokens / rep_r8.wall_s:.1f}",
        rounds_refills=len(eng_r8.refill_stats), **witness,
        launches_flash=launches["flash_attention"],
        launches_decode=launches["decode_attention"],
        sampler_device_ms=draw_prof.get("device_ms"),
        sampler_kernels=draw_prof.get("kernels"),
        sampler_wall_ms=draw_prof["wall_ms"])
    del eng, eng1, eng_r, eng_r8, cache
    torch.cuda.empty_cache()


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
        start_step=0, num_steps=TRAIN_STEPS + 4)
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
    dots = train_dots_full_width(cfg, params, state, ocfg, next(batches),
                                 Model, opt, make_train_step, fa, da)
    data.close()
    result = dict(steps=TRAIN_STEPS, tokens_per_step=tokens,
                  microbatches=TRAIN_MB, flash_path=PATHS[torch.bfloat16],
                  losses="/".join(f"{x:.4f}" for x in losses),
                  peak_memory_gb=f"{peak_gb:.2f}",
                  memory_at_start_gb=f"{base_gb:.2f}",
                  launches_flash=launches["flash_attention"],
                  launches_flash_bwd=launches["flash_attention_bwd"])
    say("7 full-width bf16 train", **result)
    say("7 profile train step", **prof)
    del params, state, step, model
    torch.cuda.empty_cache()
    return {"launches_train": launches, "launches_train_dots": dots}


# ----------------------------------------------------------------- phase 7d

class ProductCount(TorchDispatchMode):
    """Counts the ``aten.mm`` calls that run.  Under selective remat a
    product the checkpoint saved is handed back in the recompute without
    reaching this mode, so it counts the products that launch a GEMM."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def captured_step(opt, step, params, state, batch):
    """``step`` with its optimizer update replaced by a capture of the
    accumulated gradients: params and state stay as they were.  Returns
    (loss, the f32 gradients in ``tree_leaves`` order)."""
    got = {}
    real = opt.apply_updates

    def capture(p, grads, s, cfg):
        got["grads"] = opt.tree_leaves(grads)
        return p, s, {}

    opt.apply_updates = capture
    try:
        _, _, met = step(params, state, batch)
    finally:
        opt.apply_updates = real
    return met["loss"], got.pop("grads")


def train_dots_full_width(cfg, params, state, ocfg, batch, Model, opt,
                          make_train_step, fa, da) -> dict:
    """Phase 7d: phase 7's params and optimizer state, one step of 2
    microbatches over 4 x 1024 tokens under ``remat_policy="dots"`` (the
    products without batch dimensions saved, the rest recomputed).
    Against a ``"full"`` step on the same params and batch: the loss and
    every gradient leaf bit for bit (the same kernels on the same inputs),
    K1 and K11 launched as often (K1 twice per layer and microbatch).  The
    ``mm`` calls that launch a GEMM equal a ``"none"`` step's (over 2 x
    1024 tokens: the count does not depend on the rows).  Then one real
    dots step: peak memory, wall ms, and a profile.  Returns its K1 and
    K11 launches."""
    from repro_torch.checkpoint.checkpoint import flatten

    steps = {policy: make_train_step(
        Model(dataclasses.replace(cfg, remat_policy=policy), device="cuda"),
        ocfg, microbatches=TRAIN_MB) for policy in ("full", "dots", "none")}
    names = list(flatten(params))       # tree_leaves' order
    mm, full_loss, full_grads = {}, None, None
    for policy in ("full", "dots", "none"):
        rows = batch if policy != "none" else {
            k: v[:TRAIN_MB] for k, v in batch.items()}
        reset_counts(fa, da)
        with ProductCount() as products:
            loss, grads = captured_step(opt, steps[policy], params, state,
                                        rows)
        torch.cuda.synchronize()
        mm[policy] = products.mm
        launches = read_counts(fa, da)
        fwd = 1 if policy == "none" else 2
        want = {"flash_attention": fwd * cfg.n_layers * TRAIN_MB,
                "flash_attention_bwd": cfg.n_layers * TRAIN_MB}
        expect(launches == {n: want.get(n, 0) for n in launches},
               f"7d {policy}: launches {launches}, want {want}")
        if policy == "full":            # the f32 gradients wait on the host
            full_loss, full_grads = loss, [g.cpu() for g in grads]
        elif policy == "dots":
            differ = next((n for n, a, b in zip(names, full_grads, grads)
                           if not torch.equal(a, b.cpu())), None)
            expect(differ is None, f"7d: the dots gradients differ from "
                                   f"full's, first at {differ}")
            expect(torch.equal(loss, full_loss),
                   f"7d: dots loss {loss.item()} != full's "
                   f"{full_loss.item()}")
            full_grads = None
        del grads
        torch.cuda.empty_cache()
    expect(mm["dots"] == mm["none"] < mm["full"],
           f"7d: mm calls that ran {mm}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, da)
    t0 = time.perf_counter()
    _, _, met = steps["dots"](params, state, batch)
    loss = met["loss"].item()           # ends in a device sync
    ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_counts(fa, da)
    expect(loss == full_loss.item(),
           f"7d: the dots step's loss {loss} != the full step's")
    prof = profile(lambda: steps["dots"](params, state, batch), 1, top=4)
    say("7d full-width bf16 train step, remat dots", loss=f"{loss:.6f}",
        loss_and_grads_equal_full="bits",
        launches_flash=launches["flash_attention"],
        launches_flash_bwd=launches["flash_attention_bwd"],
        mm_dots=mm["dots"], mm_none=mm["none"], mm_full=mm["full"],
        peak_memory_gb=f"{peak_gb:.2f}", wall_ms=f"{ms:.1f}",
        tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}")
    say("7d profile dots train step", **prof)
    return {n: launches[n] for n in ("flash_attention",
                                     "flash_attention_bwd")}


# ------------------------------------------------------------------ phase 8

# The calibration fit on the card against the same fit on the CPU: the
# final loss within this relative error, the fitted predictions on the
# points within CAL_PRED_RTOL, and the blocks suggested for each fitted
# platform at its full thread count within 1 (the CPU tests' tolerances
# against the JAX package's fit).  The paper's 26 inference rows are not
# held here: they lie outside this fit's points, where its rational form
# can sit near a pole (one card run found the points' predictions 4.5e-5
# apart and one of those rows' blocks 1211 apart).
CAL_LOSS_RTOL, CAL_PRED_RTOL = 1e-3, 1e-2
FIT_PROFILE_STEPS = 200


def fits_agree(card_ctx, cpu_ctx, topologies) -> tuple:
    """Fail unless two calibrations of the same points (``topologies``')
    agree: every field but the parameters and the loss equal, the loss
    within CAL_LOSS_RTOL, the predictions on the points within
    CAL_PRED_RTOL and each platform's block within 1.  Returns the points
    and the three differences."""
    import importlib

    from repro_torch.core import cost_model as cm
    from repro_torch.core.atomic_sim import UnitTask

    cal = importlib.import_module("repro_torch.core.runtime.calibrate")
    x, y, _ = cal.generate_points(topologies=topologies)
    want = cm.predict(cpu_ctx.params, x)
    pred_rel = float(np.max(np.abs(cm.predict(card_ctx.params, x) - want)
                            / np.abs(want)))
    loss_rel = abs(card_ctx.fit_loss - cpu_ctx.fit_loss) / cpu_ctx.fit_loss
    blocks = {}
    task = UnitTask()
    for topo in topologies:
        t = topo.total_cores
        feats = cm.WorkloadFeatures(
            core_groups=topo.groups_used(t), threads=t,
            unit_read=task.unit_read, unit_write=task.unit_write,
            unit_comp=task.unit_comp)
        for n in (None, 512):
            blocks[f"{topo.name}, n={n}"] = (card_ctx.suggest_block(feats, n)
                                             - cpu_ctx.suggest_block(feats, n))
    same = {k: v for k, v in card_ctx.as_json_dict().items()
            if k not in ("params", "fit_loss")}
    expect(same == {k: v for k, v in cpu_ctx.as_json_dict().items()
                    if k not in ("params", "fit_loss")}
           and loss_rel <= CAL_LOSS_RTOL and pred_rel <= CAL_PRED_RTOL
           and max(map(abs, blocks.values())) <= 1,
           f"8: the card's fit against the CPU's: loss {loss_rel}, "
           f"predictions {pred_rel}, blocks {blocks}")
    return x, y, loss_rel, pred_rel, blocks


def calibrate_on_host() -> dict:
    """Phase 8: the host FAA calibrator on the card's machine.  The host
    microbenchmarks (FAA, contended transfer and dispatch ns of this
    machine's CPU, not the card), ``run_calibration`` at full size with
    that measurement on the card and on the CPU (points, fit loss, wall
    s; the two fits agree), a profile of the eager fit's steps on the
    card, the ranking against the event model on the paper's platforms
    and this host, the knobs under the calibrated context beside the
    default's, and ``launch.calibrate --no-persist``.  Nothing persists:
    the process context is reset to the default afterwards and no
    calibration file is left."""
    import importlib

    from repro_torch.core import autotune, prng, runtime
    from repro_torch.core import cost_model as cm
    from repro_torch.core.atomic_sim import UnitTask
    from repro_torch.core.topology import PLATFORMS
    from repro_torch.launch import calibrate as launch_calibrate

    cal = importlib.import_module("repro_torch.core.runtime.calibrate")
    default_file = (Path(__file__).resolve().parent / "results"
                    / "calibration_torch.json")
    expect(runtime.calibration_path() is None and not default_file.exists(),
           "phase 8 runs with REPRO_CALIBRATION=off and no calibration file")
    meas = runtime.measure_host()
    say("8 host measurement (this machine's CPU)",
        faa_ns=f"{meas.faa_ns:.1f}", transfer_ns=f"{meas.transfer_ns:.1f}",
        dispatch_ns=f"{meas.dispatch_ns:.1f}", cores=meas.cores,
        transfer_measured=meas.transfer_measured)
    fits = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fits[device] = cal.run_calibration(measurement=meas, device=device)
        ctx = fits[device]
        say(f"8 run_calibration on {device}", source=ctx.source,
            points=ctx.n_points, fit_loss=f"{ctx.fit_loss:.6g}",
            wall_s=f"{time.perf_counter() - t0:.2f}")
    card_ctx, cpu_ctx = fits["cuda"], fits["cpu"]
    topologies = list(cal._PAPER_TOPOLOGIES)
    if meas.cores > 1:
        topologies.append(cal.host_topology(meas))
    x, y, loss_rel, pred_rel, blocks = fits_agree(card_ctx, cpu_ctx,
                                                  topologies)
    say("8 card fit against the CPU fit", fit_loss_rel=f"{loss_rel:.3g}",
        prediction_rel=f"{pred_rel:.3g}",
        block_diff_max=max(map(abs, blocks.values())))
    # the eager fit on the card, a few steps profiled (12 restarts, the
    # full-size points)
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(y, device="cuda")
    inits = cm.init_params(prng.split(prng.prng_key(0), 12), x.shape[1] - 1)
    prof = profile(lambda: cm._train(inits, xt, yt, FIT_PROFILE_STEPS, 0.01),
                   1)
    say(f"8 profile {FIT_PROFILE_STEPS} fit steps on the card", **prof)
    for topo in list(PLATFORMS.values()) + topologies[3:]:
        r = runtime.ranking_consistency(card_ctx, topo, topo.total_cores,
                                        UnitTask())
        say(f"8 ranking {topo.name}", threads=r["threads"],
            spearman_sim_vs_analytic=f"{r['spearman_sim_vs_analytic']:.3f}",
            sim_best_block=r["sim_best_block"],
            model_block=r["model_block"],
            model_within_nt=r["model_within_nt"])
    knobs = {}
    try:
        for name, ctx in (("default", cal.default_context()),
                          ("calibrated", card_ctx)):
            runtime.set_tuning(ctx)
            knobs[name] = dict(
                admission_block_4096_8=ctx.admission_block(4096, 8),
                data_grain_4096=ctx.data_grain(4096),
                choose_block_4096_8=autotune.choose_block(4096, 8),
                draft_span=ctx.draft_span(),
                kernel_prior_overhead_us=f"{autotune._overhead() * 1e6:.3g}")
            say(f"8 knobs, {name} context", **knobs[name])
        launched = launch_calibrate.main(["--no-persist", "--device",
                                          "cuda"])
        expect(launched.n_points == card_ctx.n_points
               and np.isfinite(launched.fit_loss),
               f"8: launch.calibrate gave {launched.n_points} points")
    finally:
        runtime.reset_tuning()
    expect(runtime.tuning().source == "default"
           and not default_file.exists(),
           "8: a calibration outlived the phase")
    return knobs


# ------------------------------------------------------------------ phase 6

class RowShape(NamedTuple):
    """An attention shape of phase 6's K1-K10 rows: ``hq`` query heads on
    ``hkv`` KV heads of ``d``; the prefill of ``sq`` tokens into the
    1024-row cache (kv_len = sq); the decode tick's 8 slots against that
    cache at ``lens`` (the served prompt lengths) + 16, mid-way through
    decode; by wrapper name, each kernel's launches on the main path and
    its error against its plain version (phases 2-3p)."""
    hq: int
    hkv: int
    d: int
    sq: int
    lens: np.ndarray
    launches: dict
    errs: dict


# the main-path run whose launches each K1-K10 row reports: phase 5's
# bf16, paged, int8 and int8 paged serves, and 5t's serves with the db
# pinned to depth 2 for the rings
LAUNCH_RUNS = {"flash_attention": "", "decode_attention": "",
               "paged_decode_attention": "_paged",
               "flash_attention_quantized": "_int8",
               "decode_attention_quantized": "_int8",
               "paged_decode_attention_quantized": "_int8_paged",
               "flash_attention_pipelined": "_pinned",
               "decode_attention_pipelined": "_pinned",
               "paged_decode_attention_pipelined": "_pinned_paged",
               "paged_decode_attention_quantized_pipelined": "_pinned_int8"}


def row_shapes(main_path, errs_fa, errs_da, errs_pa, errs_q, errs_p,
               errs_d80) -> tuple:
    """qwen2.5-3b's shape (16 query heads on 2 KV heads of 128, the
    512-wide prefill, phase 5's lengths) and zamba2-2.7b's (32 on 32 of
    80, G = 1, the 488-token prefill, phase 5h's lengths; 5h takes no
    tuned path, so its rings' launches are 5h's zeros)."""
    bf16, i8 = torch.bfloat16, torch.int8
    qwen = RowShape(
        16, 2, 128, 512, main_path["serve_lens"],
        {n: main_path["launches" + run][n] for n, run in LAUNCH_RUNS.items()},
        {"flash_attention": errs_fa[(bf16, 512, 512)],
         "decode_attention": errs_da[bf16],
         "paged_decode_attention": errs_pa[bf16],
         "flash_attention_quantized": errs_q[("k10", i8, 512, 512)],
         "decode_attention_quantized": errs_q[("k7", i8)],
         "paged_decode_attention_quantized": errs_q[("k8", i8)],
         "flash_attention_pipelined": errs_p[("k4", bf16, 512)],
         "decode_attention_pipelined": errs_p[("k5", bf16)],
         "paged_decode_attention_pipelined": errs_p[("k6", bf16)],
         "paged_decode_attention_quantized_pipelined": errs_p[("k9", i8)]})
    zamba = RowShape(
        32, 32, D80, 488, main_path["hybrid_serve_lens"],
        {n: main_path["launches_hybrid" + run.replace("_pinned", "")][n]
         for n, run in LAUNCH_RUNS.items()},
        {"flash_attention": errs_d80[("k1", bf16)],
         "decode_attention": errs_d80[("k2", bf16)],
         "paged_decode_attention": errs_d80[("k3", bf16)],
         "flash_attention_quantized": errs_d80[("k10", i8, bf16)],
         "decode_attention_quantized": errs_d80[("k7", i8, bf16)],
         "paged_decode_attention_quantized": errs_d80[("k8", i8, bf16)],
         "flash_attention_pipelined": errs_d80[("k4", bf16)],
         "decode_attention_pipelined": errs_d80[("k5", bf16)],
         "paged_decode_attention_pipelined": errs_d80[("k6", bf16)],
         "paged_decode_attention_quantized_pipelined":
             errs_d80[("k9", i8, bf16)]})
    return qwen, zamba


def decode_lengths(sh: RowShape, s: int = 1024) -> torch.Tensor:
    return torch.tensor(np.minimum(sh.lens[:8] + 16, s), dtype=torch.int32,
                        device="cuda")


def prefill_sdpa_ms(sets, kvl: int) -> float:
    """One causal ``scaled_dot_product_attention`` call over each set's
    q [B, Sq, Hq, D] and first ``kvl`` rows of k, v [B, Skv, Hkv, D]."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [(q.transpose(1, 2), k[:, :kvl].transpose(1, 2),
                 v[:, :kvl].transpose(1, 2)) for q, k, v, *_ in sets]
    return time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True), lib_sets)


def decode_sdpa_ms(sets, kv_len: torch.Tensor) -> float:
    """One ``scaled_dot_product_attention`` call over each set's q [B, Hq,
    D] and k, v [B, S, Hkv, D], masked past ``kv_len``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = sets[0][1].shape[1]
    mask = (torch.arange(s, device="cuda")[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v, *_ in sets]
    return time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                        enable_gqa=True), lib_sets)


def prefill_work(sh: RowShape, quantized: bool) -> tuple:
    """(operations, bytes) of the prefill at ``sh``: the causal pairs'
    two products; q and out in bf16, the live K and V rows (1-byte ones
    with a 2-byte scale), the f32 lse."""
    b, sq, kvl, d = 1, sh.sq, sh.sq, sh.d
    pairs = sum(min(i + 1, kvl) for i in range(sq))          # causal (q, k)
    kv = (2 * b * kvl * sh.hkv * (d + 2) if quantized
          else 2 * 2 * b * kvl * sh.hkv * d)
    return (4 * d * sh.hq * b * pairs,
            2 * 2 * b * sq * sh.hq * d + kv + 4 * b * sh.hq * sq)


def decode_work(sh: RowShape, kv_len, quantized: bool,
                paged: bool) -> tuple:
    """(operations, bytes) of a decode tick at ``sh``: the live rows' two
    products; the live K and V rows (1-byte ones with a 2-byte scale),
    q and out in bf16, kv_len, and the page-table entries read."""
    b, d = 8, sh.d
    live = int(kv_len.sum())
    kv = (2 * live * sh.hkv * (d + 2) if quantized
          else 2 * 2 * live * sh.hkv * d)
    nbytes = kv + 2 * 2 * b * sh.hq * d + 4 * b
    if paged:
        nbytes += 4 * int(((kv_len + PAGE_SIZE - 1) // PAGE_SIZE).sum())
    return 4 * d * sh.hq * live, nbytes


def kernel_rows(fa, da, gen, sh: RowShape) -> list:
    """K1 at the prefill, K2 at the decode tick, K3 on the same rows from
    a 513-page pool through a seeded page placement, beside K2 on the
    rows gathered to a contiguous cache (the page indirection's cost) and
    one SDPA call on the gathered rows."""
    bf16 = torch.bfloat16
    hq, hkv, d = sh.hq, sh.hkv, sh.d
    rows = []

    b, sq, skv, kvl = 1, sh.sq, 1024, sh.sq
    sets = [(randn(gen, (b, sq, hq, d), bf16), randn(gen, (b, skv, hkv, d), bf16),
             randn(gen, (b, skv, hkv, d), bf16)) for _ in range(16)]
    ms = time_ms(lambda q, k, v: fa.flash_attention(
        q, k, v, kv_len=kvl, q_offset=0), sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, kv_len=kvl, q_offset=0), sets, iters=5)
    rows.append(_row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:77",
                     sh.launches["flash_attention"],
                     sh.errs["flash_attention"], ms, plain_ms,
                     *prefill_work(sh, False), prefill_sdpa_ms(sets, kvl)))
    rows[-1]["path"] = PATHS[bf16]
    del sets

    b, s = 8, 1024
    kv_len = decode_lengths(sh, s)
    flops, nbytes = decode_work(sh, kv_len, False, False)
    sets = [(randn(gen, (b, hq, d), bf16), randn(gen, (b, s, hkv, d), bf16),
             randn(gen, (b, s, hkv, d), bf16)) for _ in range(8)]
    ms = time_ms(lambda q, k, v: da.decode_attention(q, k, v, kv_len), sets)
    plain_ms = time_ms(lambda q, k, v: da.decode_attention_plain(
        q, k, v, kv_len), sets, iters=10)
    rows.append(_row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention/kernel.py:63",
                     sh.launches["decode_attention"],
                     sh.errs["decode_attention"], ms, plain_ms, flops, nbytes,
                     decode_sdpa_ms(sets, kv_len)))
    del sets

    sets = [paged_inputs(gen, bf16, kv_len.tolist(), hq=hq, hkv=hkv, d=d)
            for _ in range(8)]
    ms = time_ms(lambda q, kp, vp, pt, kl: da.paged_decode_attention(
        q, kp, vp, pt, kl), sets)
    plain_ms = time_ms(lambda q, kp, vp, pt, kl:
                       da.paged_decode_attention_plain(q, kp, vp, pt, kl),
                       sets, iters=10)
    gathered_sets = [(q, gathered(kp, pt), gathered(vp, pt), kl)
                     for q, kp, vp, pt, kl in sets]
    k2_ms = time_ms(lambda q, k, v, kl: da.decode_attention(q, k, v, kl),
                    gathered_sets)
    row = _row("paged_decode_attention",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:422",
               sh.launches["paged_decode_attention"],
               sh.errs["paged_decode_attention"], ms, plain_ms,
               *decode_work(sh, kv_len, False, True), None)
    row["k2_gathered_ms"] = k2_ms
    row["sdpa_gathered_ms"] = decode_sdpa_ms(gathered_sets, kv_len)
    rows.append(row)
    return rows


def in_turns(fns, sets, iters: int = 30) -> list:
    """Device ms of each of ``fns`` on the same input sets, measured in
    turns (each twice: forwards, then backwards) and averaged, so that a
    drift of the card between measurements falls on all of them alike."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    ms = [0.0] * len(fns)
    for i in order:
        ms[i] += time_ms(fns[i], sets, iters) / 2
    return ms


def pipelined_kernel_rows(fa, da, quant, gen, sh: RowShape) -> list:
    """K4, K5, K6 and K9 at K1's, K2's, K3's and K8's shapes and lengths
    (above): each at depths 2 and 4 beside its classic kernel, timed in
    turns on the same inputs; the bound is the classic's (the same
    function: the same bytes and operations); the plain version is the
    classic's.  The library call is K1's for K4 and K2's for K5 (one
    ``scaled_dot_product_attention`` call), none for the paged ones:
    beside K6 stands SDPA on the gathered rows, beside K9 on the gathered
    rows dequantized to bf16.  ``ms`` is the depth-2 time."""
    bf16, i8 = torch.bfloat16, torch.int8
    hq, hkv, d = sh.hq, sh.hkv, sh.d
    rows = []

    def row(name, replaces, times, plain_ms, work, lib_ms, classic,
            ops_dtype=bf16):
        classic_ms, ms2, ms4 = times
        r = _row(name, "src/repro_torch/csrc/" + (
            "flash_attention.cu" if name.startswith("flash")
            else "decode_attention.cu"), replaces, sh.launches[name],
            sh.errs[name], ms2, plain_ms, *work, lib_ms, ops_dtype=ops_dtype)
        r.update({"ms_depth2": ms2, "ms_depth4": ms4,
                  f"{classic}_same_shape_ms": classic_ms})
        return r

    # K4 at K1's prefill
    b, sq, skv, kvl = 1, sh.sq, 1024, sh.sq
    sets = [(randn(gen, (b, sq, hq, d), bf16), randn(gen, (b, skv, hkv, d), bf16),
             randn(gen, (b, skv, hkv, d), bf16)) for _ in range(16)]
    times = in_turns([
        lambda q, k, v, nb=nb: (fa.flash_attention if nb == 1 else
                                fa.flash_attention_pipelined)(
            q, k, v, kv_len=kvl, q_offset=0, num_buffers=nb)
        for nb in (1, 2, 4)], sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, kv_len=kvl, q_offset=0), sets, iters=5)
    rows.append(row(
        "flash_attention_pipelined",
        "src/repro/kernels/flash_attention/kernel.py:235", times, plain_ms,
        prefill_work(sh, False), prefill_sdpa_ms(sets, kvl), "k1"))
    rows[-1]["path"] = PATHS[bf16]
    del sets

    # K5 at K2's decode tick
    b, s = 8, 1024
    kv_len = decode_lengths(sh, s)
    sets = [(randn(gen, (b, hq, d), bf16), randn(gen, (b, s, hkv, d), bf16),
             randn(gen, (b, s, hkv, d), bf16)) for _ in range(8)]
    times = in_turns([
        lambda q, k, v, nb=nb: (da.decode_attention if nb == 1 else
                                da.decode_attention_pipelined)(
            q, k, v, kv_len, num_buffers=nb) for nb in (1, 2, 4)], sets)
    plain_ms = time_ms(lambda q, k, v: da.decode_attention_plain(
        q, k, v, kv_len), sets, iters=10)
    rows.append(row(
        "decode_attention_pipelined",
        "src/repro/kernels/decode_attention/kernel.py:201", times, plain_ms,
        decode_work(sh, kv_len, False, False), decode_sdpa_ms(sets, kv_len),
        "k2"))
    del sets

    # K6 at K3's paged shape
    sets = [paged_inputs(gen, bf16, kv_len.tolist(), hq=hq, hkv=hkv, d=d)
            for _ in range(8)]
    times = in_turns([
        lambda q, kp, vp, pt, kl, nb=nb: (
            da.paged_decode_attention if nb == 1 else
            da.paged_decode_attention_pipelined)(q, kp, vp, pt, kl,
                                                 num_buffers=nb)
        for nb in (1, 2, 4)], sets)
    plain_ms = time_ms(da.paged_decode_attention_plain, sets, iters=10)
    rows.append(row(
        "paged_decode_attention_pipelined",
        "src/repro/kernels/decode_attention/kernel.py:556", times, plain_ms,
        decode_work(sh, kv_len, False, True), None, "k3"))
    rows[-1]["library"] = "none: no PyTorch call attends through a page table"
    rows[-1]["sdpa_gathered_ms"] = decode_sdpa_ms(
        [(q, gathered(kp, pt), gathered(vp, pt)) for q, kp, vp, pt, _ in sets],
        kv_len)
    del sets

    # K9 at K8's shape: int8 pools
    sets = []
    for _ in range(16):
        q, kp, vp, pt, kl = paged_inputs(gen, bf16, kv_len.tolist(), hq=hq,
                                         hkv=hkv, d=d)
        kq, ks = quantized(quant, kp, i8)
        vq, vs = quantized(quant, vp, i8)
        sets.append((q, kq, ks, vq, vs, pt, kl))
        del kp, vp
    times = in_turns([
        lambda *a, nb=nb: (
            da.paged_decode_attention_quantized if nb == 1 else
            da.paged_decode_attention_quantized_pipelined)(*a, num_buffers=nb)
        for nb in (1, 2, 4)], sets)
    plain_ms = time_ms(da.paged_decode_attention_quantized_plain, sets,
                       iters=10)
    rows.append(row(
        "paged_decode_attention_quantized_pipelined",
        "src/repro/kernels/decode_attention/kernel.py:815", times, plain_ms,
        decode_work(sh, kv_len, True, True), None, "k8", ops_dtype=i8))
    rows[-1]["library"] = ("none: no PyTorch call attends over a scaled int8 "
                           "cache through a page table")
    rows[-1]["sdpa_dequantized_ms"] = decode_sdpa_ms(
        [dequantized_rows(quant, q, kq, ks, vq, vs, pt)
         for q, kq, ks, vq, vs, pt, _ in sets[:8]], kv_len)
    return rows


def dequantized_rows(quant, q, kq, ks, vq, vs, pt=None) -> tuple:
    """(q, k, v) with the 1-byte K and V rows (gathered through the page
    table ``pt``, if given) dequantized to bf16."""
    if pt is not None:
        kq, ks, vq, vs = (gathered_bytes(quant, t, pt)
                          for t in (kq, ks, vq, vs))
    return (q, quant.dequantize(kq, ks).to(torch.bfloat16),
            quant.dequantize(vq, vs).to(torch.bfloat16))


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
    row["train_dots_launches"] = \
        main_path["launches_train_dots"]["flash_attention_bwd"]
    row["k1_same_shape_ms"] = k1_ms
    row["path"] = PATHS[bf16]
    return row


def quant_kernel_rows(fa, da, quant, gen, sh: RowShape) -> list:
    """K10, K7 and K8 on an int8 cache at K1's, K2's and K3's shapes and
    lengths.  No single PyTorch call attends over a scaled int8 cache;
    beside each kernel stand its float twin (K1 or K2) and one SDPA call
    on the same rows dequantized to bf16, and beside K8 also K7 on the
    gathered rows."""
    bf16, i8 = torch.bfloat16, torch.int8
    hq, hkv, d = sh.hq, sh.hkv, sh.d
    rows = []

    # K10 at the prefill into the 1024-row int8 cache
    b, sq, skv, kvl = 1, sh.sq, 1024, sh.sq
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
    deq_sets = [dequantized_rows(quant, *st) for st in sets]
    k1_ms = time_ms(lambda q, k, v: fa.flash_attention(
        q, k, v, kv_len=kvl, q_offset=0), deq_sets)
    row = _row("flash_attention_quantized",
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:373",
               sh.launches["flash_attention_quantized"],
               sh.errs["flash_attention_quantized"], ms, plain_ms,
               *prefill_work(sh, True), None, ops_dtype=i8)
    row["k1_dequantized_ms"] = k1_ms
    row["sdpa_dequantized_ms"] = prefill_sdpa_ms(deq_sets, kvl)
    row["path"] = PATHS[bf16]
    rows.append(row)
    del sets, deq_sets

    # K7 at the decode tick over the 1024-row int8 cache: 16 input sets,
    # the footprint of K2's 8 bf16 sets
    b, s = 8, 1024
    kv_len = decode_lengths(sh, s)
    flops, nbytes = decode_work(sh, kv_len, True, False)
    sets = []
    for _ in range(16):
        kq, ks = quantized(quant, randn(gen, (b, s, hkv, d), bf16), i8)
        vq, vs = quantized(quant, randn(gen, (b, s, hkv, d), bf16), i8)
        sets.append((randn(gen, (b, hq, d), bf16), kq, ks, vq, vs, kv_len))
    ms = time_ms(da.decode_attention_quantized, sets)
    plain_ms = time_ms(da.decode_attention_quantized_plain, sets, iters=10)
    # K2 and SDPA on 8 dequantized sets: the bf16 footprint of K2's row
    deq_sets = [dequantized_rows(quant, *st[:5]) for st in sets[:8]]
    k2_ms = time_ms(lambda q, k, v: da.decode_attention(q, k, v, kv_len),
                    deq_sets)
    row = _row("decode_attention_quantized",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:316",
               sh.launches["decode_attention_quantized"],
               sh.errs["decode_attention_quantized"], ms, plain_ms, flops,
               nbytes, None, ops_dtype=i8)
    row["k2_dequantized_ms"] = k2_ms
    row["sdpa_dequantized_ms"] = decode_sdpa_ms(deq_sets, kv_len)
    rows.append(row)
    del sets, deq_sets

    # K8 on the same rows and lengths from a 513-page int8 pool through a
    # seeded page placement
    sets = []
    for _ in range(16):
        q, kp, vp, pt, kl = paged_inputs(gen, bf16, kv_len.tolist(), hq=hq,
                                         hkv=hkv, d=d)
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
    deq_sets = [dequantized_rows(quant, *st[:5]) for st in gathered_sets[:8]]
    k2_ms = time_ms(lambda q, k, v: da.decode_attention(q, k, v, kv_len),
                    deq_sets)
    row = _row("paged_decode_attention_quantized",
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:668",
               sh.launches["paged_decode_attention_quantized"],
               sh.errs["paged_decode_attention_quantized"], ms, plain_ms,
               *decode_work(sh, kv_len, True, True), None, ops_dtype=i8)
    row["k7_gathered_ms"] = k7_ms
    row["k2_dequantized_ms"] = k2_ms
    row["sdpa_dequantized_ms"] = decode_sdpa_ms(deq_sets, kv_len)
    rows.append(row)
    return rows


def ssd_flops(b, s, h, p, g, n, chunk=64) -> int:
    """Operations (2 per multiply-add) of the chunked scan on these shapes,
    counting what the data needs: per chunk of q valid rows, C B^T once
    per group over the q (q + 1) / 2 causal pairs, and per head the masked
    product with x over those pairs, C state^T and the state update over
    q x P x N."""
    total = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        total += g * 2 * pairs * n + h * (2 * pairs * p + 2 * 2 * q * p * n)
    return b * total


def ssd_kernel_rows(ss, quant, gen, main_path, errs_ssd) -> list:
    """K12 and K13 at the main-path shape (B=1, S=512, H=48, P=64, G=1,
    N=128; bf16, K13 with int8 x): 16 input sets of 3.5 MB, past the L2;
    K12 also at zamba2's (``SSD_CASES["hybrid"]``, phase 5h's launches) as
    ``hybrid_*`` fields of its row.  No PyTorch call computes an SSD scan,
    so neither row has a library time; beside K13 stands K12 on the same
    x dequantized to bf16."""
    bf16, i8 = torch.bfloat16, torch.int8
    no_library = "none: no PyTorch call computes an SSD scan"

    def k12(case, launches):
        b, s, h, p, g, n, _ = SSD_CASES[case]
        sets = [ssd_inputs(gen, b, s, h, p, g, n, bf16) for _ in range(16)]
        ms = time_ms(ss.ssd, sets)
        plain_ms = time_ms(ss.ssd_plain, sets, iters=5)
        # x and y, dt, a, B and C, the f32 final state
        common = (4 * b * s * h + 4 * h + 2 * 2 * b * s * g * n
                  + 4 * b * h * p * n)
        row = _row("ssd", "src/repro_torch/csrc/mamba_ssd.cu",
                   "src/repro/kernels/mamba_ssd/kernel.py:72", launches,
                   errs_ssd[("k12", bf16, case)][2], ms, plain_ms,
                   ssd_flops(b, s, h, p, g, n), 2 * 2 * b * s * h * p + common,
                   None)
        return row, sets, common

    hybrid, _, _ = k12("hybrid", main_path["launches_hybrid"]["ssd"])
    row, sets, common = k12("main", main_path["launches_ssm"]["ssd"])
    row["library"] = no_library
    row["path"] = PATHS[bf16]
    row.update({f"hybrid_{k}": v for k, v in hybrid.items()
                if k not in ("name", "route", "source", "replaces")})
    rows = [row]
    b, s, h, p, g, n, _ = SSD_CASES["main"]
    flops = ssd_flops(b, s, h, p, g, n)
    qsets = []
    for x, dt, a, b_in, c_in in sets:
        xq, xs = quantized(quant, x, i8)
        qsets.append((xq, xs, dt, a, b_in, c_in))
    ms = time_ms(ss.ssd_quantized, qsets)
    plain_ms = time_ms(ss.ssd_quantized_plain, qsets, iters=5)
    deq_sets = [(quant.dequantize(xq, xs).to(bf16), dt, a, b_in, c_in)
                for xq, xs, dt, a, b_in, c_in in qsets]
    k12_ms = time_ms(ss.ssd, deq_sets)
    # int8 x and its f16 scales in, bf16 y out
    nbytes = b * s * h * p + 2 * b * s * h + 2 * b * s * h * p + common
    row = _row("ssd_quantized", "src/repro_torch/csrc/mamba_ssd.cu",
               "src/repro/kernels/mamba_ssd/kernel.py:184",
               main_path["launches_k13"]["ssd_quantized"],
               errs_ssd[("k13", i8, bf16, "main")][2], ms, plain_ms, flops,
               nbytes, None)
    row["library"] = no_library
    row["k12_dequantized_ms"] = k12_ms
    row["path"] = PATHS[bf16]
    rows.append(row)
    return rows


# ------------------------------------------------ MoE/MLA (deepseek-v2)

# K14 / K15 against their plain versions and K15 against K14 on the
# dequantized weights: the largest |difference| over the largest |value|.
# f32: summation order (and, for K15 against K14, the scale multiplying
# after the sum instead of before); bf16: both round an f32 result to bf16
# once (one ulp is at most 2^-8 of a value).
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GMM_CASES = {"reduced": (4, 8, 64, 32),
             "decode": (64, 8, 2048, 1408),       # gate / up, 8 slots
             "decode_down": (64, 8, 1408, 2048),
             "prefill": (64, 64, 2048, 1408),     # 488 tokens: capacity 64
             "ragged": (3, 24, 72, 40),
             "c1": (5, 1, 64, 32),                # C = 1, 13, 32: the
             "c13": (4, 13, 96, 144),             # weight stream's 1, 2
             "c32": (3, 32, 2048, 1408),          # and 4 n-tiles
             "c13_d36": (2, 13, 36, 40)}          # rows not 16-byte wide
# K15 through its op on the full-width prefill's expert buffers: the gate
# product over int8 weights against K14's over the bf16 weights, relative
# to its largest |value| (per-column int8 rounds each weight to within
# amax / 254; the product is linear in the weights).
K15_PATH_REL_TOL = 5e-2
MOE_ARCH = "deepseek-v2-lite-16b"


def gmm_inputs(gen, e, c, d, f, dtype):
    x = randn(gen, (e, c, d), dtype)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(dtype)
    return x, w


def check_gmm(mg, quant, gen) -> dict:
    """2d: K14 against its plain version at the reduced, decode (gate/up
    and down), prefill and ragged shapes, bf16 and f32, each call repeated
    bit for bit; K15 (int8 and fp8 weights) against its plain version and
    against K14 on the dequantized weights, each call repeated bit for
    bit, at the decode, prefill and ragged shapes and at C = 1, 13 and 32
    (bf16: the weight stream at C <= 32 with rows of whole 16-byte copies,
    the tile kernel at C > 32, each launch counted on the path the rule
    names)."""
    errs = {}
    paths = {}
    k15_paths = {}
    k15 = mg.grouped_matmul_quantized
    for dtype in (torch.bfloat16, torch.float32):
        for case, shape in GMM_CASES.items():
            x, w = gmm_inputs(gen, *shape, dtype)
            out = mg.grouped_matmul(x, w)
            again = mg.grouped_matmul(x, w)
            torch.cuda.synchronize()
            err = rel_err(out, mg.grouped_matmul_plain(x, w))
            expect(err <= GMM_TOL[dtype] and torch.equal(out, again),
                   f"K14 {dtype} {case}: rel err {err}, repeat equal "
                   f"{torch.equal(out, again)}")
            errs[("k14", dtype, case)] = err
            if dtype == torch.bfloat16:
                paths[case] = mg.path(x, w)
            if case not in ("decode", "prefill", "ragged", "c1", "c13",
                            "c32"):
                continue
            for store in QDTYPES:
                w_q, w_s = mg.quantize_expert_weights(w.float(), dtype=store)
                before = dict(k15.path_launches)
                out = mg.grouped_matmul_quantized(x, w_q, w_s)
                again = mg.grouped_matmul_quantized(x, w_q, w_s)
                torch.cuda.synchronize()
                rule = mg.path(x, w_q)
                expect(k15.path_launches[rule] == before.get(rule, 0) + 2,
                       f"K15 {store} {dtype} {case}: launches by path "
                       f"{dict(k15.path_launches)}, rule {rule}")
                if dtype == torch.bfloat16:
                    k15_paths[case] = rule
                err = rel_err(out, mg.grouped_matmul_quantized_plain(
                    x, w_q, w_s))
                k14 = mg.grouped_matmul(
                    x, quant.dequantize(w_q, w_s).to(dtype))
                err_k14 = rel_err(out, k14)
                expect(err <= GMM_TOL[dtype] and err_k14 <= GMM_TOL[dtype]
                       and torch.equal(out, again),
                       f"K15 {store} {dtype} {case}: rel err {err}, vs K14 "
                       f"{err_k14}")
                errs[("k15", store, dtype, case)] = (err, err_k14)
            del x, w
    expect(paths["decode"] == paths["decode_down"] == paths["c32"] ==
           "stream" and paths["c13_d36"] == "cuda_cores",
           f"K14 bf16 paths {paths}")
    expect(k15_paths == {"decode": "stream", "prefill": "mma",
                         "ragged": "cuda_cores", "c1": "stream",
                         "c13": "stream", "c32": "stream"},
           f"K15 bf16 paths {k15_paths}")
    say("2d K14 vs plain (rel)", **{
        f"{str(k[1])[6:]}_{k[2]}": f"{v:.3g}" for k, v in errs.items()
        if k[0] == "k14"}, **{f"bf16_{c}_path": p for c, p in paths.items()})
    say("2d K15 vs plain / vs K14 on dequantized weights (rel)", **{
        f"{str(k[1])[6:]}_{str(k[2])[6:]}_{k[3]}": f"{v[0]:.3g}/{v[1]:.3g}"
        for k, v in errs.items() if k[0] == "k15"},
        **{f"bf16_{c}_path": p for c, p in k15_paths.items()})
    return errs


MLA_FLASH_CASES = {"prefill": (1, 488, 488, 16, 192, 128, None),
                   "reduced": (2, 37, 64, 4, 24, 16, [37, 20])}
MLA_DECODE_CASES = {
    "decode": (8, 1024, 16, 576, 512, [1, 100, 1024, 2000, 513, 64, 300,
                                       777]),
    "reduced": (3, 40, 4, 40, 32, [1, 40, 17])}


def mla_decode_inputs(gen, b, s, g, dk, dv, dtype):
    """q [B, G, Dk], the latent cache as K [B, S, 1, Dk] and V its first
    Dv columns (a separate tensor, as MLA's decode passes it)."""
    q = randn(gen, (b, g, dk), dtype)
    k = randn(gen, (b, s, 1, dk), dtype)
    return q, k, k[..., :dv].contiguous()


def check_mla_attention(fa, da, gen) -> dict:
    """2e: K1 at MLA's prefill pairs (192 / 128 at full width: B=1, 488
    tokens, 16 heads; 24 / 16 reduced, per-row kv_len) and K2 at the
    absorbed decode's (576 / 512: B=8, S=1024, one latent KV head, G=16,
    ragged lengths; 40 / 32 reduced) against their plain versions, bf16
    and f32; then K3 on a paged copy of the decode rows, bit for bit
    equal to K2 on them."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, (b, sq, skv, h, dk, dv, kv_len) in MLA_FLASH_CASES.items():
            q = randn(gen, (b, sq, h, dk), dtype)
            k = randn(gen, (b, skv, h, dk), dtype)
            v = randn(gen, (b, skv, h, dv), dtype)
            kl = (None if kv_len is None else
                  torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
            out, lse = fa.flash_attention(q, k, v, kv_len=kl, q_offset=0)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_len=kl,
                                                    q_offset=0)
            err = max_err(out, ref)
            expect(out.shape == (b, sq, h, dv) and err <= TOL[dtype]
                   and max_err(lse, ref_lse) <= 1e-3,
                   f"K1 ({dk}, {dv}) {dtype}: err {err}")
            errs[("k1", dtype, case)] = err
        for case, (b, s, g, dk, dv, kv_len) in MLA_DECODE_CASES.items():
            q, k, v = mla_decode_inputs(gen, b, s, g, dk, dv, dtype)
            kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            out = da.decode_attention(q, k, v, kl)
            torch.cuda.synchronize()
            err = max_err(out, da.decode_attention_plain(q, k, v, kl))
            expect(out.shape == (b, g, dv) and err <= TOL[dtype],
                   f"K2 ({dk}, {dv}) {dtype}: err {err}")
            errs[("k2", dtype, case)] = err
            # K3: the same rows as pages of 16 (page 0 scratch), in order
            pages = -(-s // PAGE_SIZE)
            pad = pages * PAGE_SIZE - s
            k_pad = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v_pad = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            pt = (torch.arange(b * pages, dtype=torch.int32, device="cuda")
                  .reshape(b, pages) + 1)
            k_pool = torch.cat([k_pad.new_zeros((1, PAGE_SIZE, 1, dk)),
                                k_pad.reshape(b * pages, PAGE_SIZE, 1, dk)])
            v_pool = torch.cat([v_pad.new_zeros((1, PAGE_SIZE, 1, dv)),
                                v_pad.reshape(b * pages, PAGE_SIZE, 1, dv)])
            paged = da.paged_decode_attention(q, k_pool, v_pool, pt, kl)
            expect(torch.equal(paged, da.decode_attention(q, k_pad, v_pad,
                                                          kl)),
                   f"K3 != K2 at ({dk}, {dv}) {dtype}")
    say("2e K1/K2 at MLA's pairs vs plain; K3 == K2",
        k1_bf16_path=PATHS[torch.bfloat16], **{
        f"{k[0]}_{str(k[1])[6:]}_{k[2]}": f"{v:.3g}"
        for k, v in errs.items()}, k3_equals_k2=True)
    return errs


def check_reduced_moe(get_config, Model, Engine, ServeConfig, fa, da,
                      mg) -> None:
    """4d: the reduced f32 deepseek-v2-lite-16b on the card (K1 and K2 at
    the reduced MLA pairs, K14) against the CPU (plain versions):
    first-token logits of a prefill, 3 decode steps, and greedy serve on
    the contiguous cache; K14 launched 3 times per MoE layer of every
    forward."""
    cfg = get_config(MOE_ARCH).reduced()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    params_cpu = cpu.init(SEED)
    params_gpu = to_device(params_cpu, "cuda")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    rng = np.random.RandomState(SEED)
    toks = rng.randint(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    lc, cc = cpu.prefill(params_cpu, {"tokens": toks}, 64, torch.float32)
    torch.cuda.synchronize()
    reset_counts(fa, da)
    lg, cg = gpu.prefill(params_gpu, {"tokens": toks}, 64, torch.float32)
    torch.cuda.synchronize()
    k14_per_forward = read_counts(fa, da)["grouped_matmul"]
    prefill_err = max_err(lg.cpu(), lc)
    decode_err = 0.0
    for _ in range(3):
        nxt = rng.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        dc, cc = cpu.decode_step(params_cpu, nxt, cc)
        dg, cg = gpu.decode_step(params_gpu, nxt, cg)
        decode_err = max(decode_err, max_err(dg.cpu(), dc))
    expect(prefill_err <= LOGIT_TOL and decode_err <= LOGIT_TOL
           and k14_per_forward == 3 * n_moe,
           f"reduced deepseek: prefill {prefill_err}, decode {decode_err}, "
           f"K14 launches a forward {k14_per_forward}")
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 5, 37, 60, 17, 3, 44, 9)]
    scfg = ServeConfig(max_len=80, slots=3, refill_schedule="faa")
    out_cpu = Engine(cpu, params_cpu, scfg).serve(prompts, 12)
    eng = Engine(gpu, params_gpu, scfg)
    out_gpu, launches = drive(eng, prompts, fa, da, n_new=12)
    same = all(same_tokens(out_cpu, out_gpu))
    forwards = len(prompts) + eng.last_report.total_ticks
    expect(same and launched_only(launches, ("flash_attention",
                                             "decode_attention",
                                             "grouped_matmul"))
           and launches["grouped_matmul"] == 3 * n_moe * forwards,
           f"reduced deepseek serve: tokens equal {same}, launches "
           f"{launches}, forwards {forwards}")
    say("4d reduced f32 deepseek-v2-lite card vs cpu",
        prefill_logit_err=f"{prefill_err:.3g}",
        decode_logit_err=f"{decode_err:.3g}", requests=len(prompts),
        tokens_equal_cpu=same, k14_per_forward=k14_per_forward,
        launches_k14=launches["grouped_matmul"],
        launches_flash=launches["flash_attention"],
        launches_decode=launches["decode_attention"])


def serve_moe_full_width(get_config, Model, Engine, ServeConfig, fa, da, mg,
                         quant) -> dict:
    """5d: full-width deepseek-v2-lite-16b in bf16 (weights from the seed,
    every earlier phase's tensors freed) serving the 16 requests of phase
    5 through 8 slots on the contiguous cache, 32 new tokens each: every
    prefill through K1 at (192, 128), every tick through K2 at (576, 512),
    every MoE layer's three expert products through K14, and nothing
    else.  Then a profiled 488-token prefill and decode tick (K14 its own
    category), the K14 launches of one forward, and K15 through its op on
    that prefill's and a decode tick's expert buffers with int8 gate
    weights.  Prints the peak device memory."""
    from repro_torch.models import moe as moe_mod

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH).with_dtype("bfloat16")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, 513, 16)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    base = dict(max_len=1024, slots=8, refill_schedule="faa",
                cache_dtype="bfloat16")
    eng = Engine(model, params, ServeConfig(**base))
    eng.serve(prompts[:2], 2)                     # warm-up (cuBLAS)
    outs, launches = drive(eng, prompts, fa, da)  # main path
    paths = read_paths(fa, da)
    rep = eng.last_report
    forwards = len(prompts) + rep.total_ticks
    k14_paths = paths.get("grouped_matmul", {})
    expect(launched_only(launches, ("flash_attention", "decode_attention",
                                    "grouped_matmul"))
           and launches["grouped_matmul"] == 3 * n_moe * forwards
           and launches["flash_attention"] == cfg.n_layers * len(prompts)
           and launches["decode_attention"] == cfg.n_layers * rep.total_ticks
           and on_path(paths, ("decode_attention",), "mma")
           and k14_paths.get("cuda_cores", 0) == 0
           and k14_paths.get("stream", 0) >= 3 * n_moe * rep.total_ticks,
           f"deepseek serve: launches {launches}, forwards {forwards}, by "
           f"path {paths}")
    expect(len(outs) == 16 and all(
        o.shape == (32,) and ((o >= 0) & (o < cfg.vocab_size)).all()
        for o in outs), "deepseek serve: malformed outputs")
    longest = prompts[int(np.argmax(lens))][None, :]

    def prefill():
        return model.prefill(params, {"tokens": longest}, base["max_len"])

    logits, _ = prefill()
    expect(bool(torch.isfinite(logits).all()), "deepseek prefill: logits "
           "not finite")
    pre = profile(prefill, 3, top=8)
    say(f"5d profile deepseek prefill ({longest.shape[1]} tokens)", **pre)
    tick = np.zeros((8, 1), np.int32)
    tick_cache = eng._backend.cache

    def decode():
        return model.decode_step(params, tick, tick_cache)

    torch.cuda.synchronize()
    reset_counts(fa, da)
    decode()
    torch.cuda.synchronize()
    tick_launches = read_counts(fa, da)
    tick_paths = read_paths(fa, da)
    expect(tick_launches["grouped_matmul"] == 3 * n_moe
           and tick_launches["decode_attention"] == cfg.n_layers
           and tick_paths["grouped_matmul"] == {"stream": 3 * n_moe}
           and tick_paths["decode_attention"] == {"mma": cfg.n_layers},
           f"deepseek decode tick: launches {tick_launches}, by path "
           f"{tick_paths}")
    tick_prof = profile(decode, 5, top=8)
    say("5d profile deepseek decode tick (8 slots)", **tick_prof)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    result = dict(
        requests=len(prompts), prompt_lens=f"{lens.min()}-{lens.max()}",
        tokens=rep.total_tokens, ticks=rep.total_ticks,
        wall_s=f"{rep.wall_s:.3f}",
        tokens_per_s=f"{rep.total_tokens / rep.wall_s:.1f}",
        prefill_wall_ms=pre["wall_ms"],
        prefill_device_ms=pre.get("device_ms"),
        decode_tick_wall_ms=tick_prof["wall_ms"],
        decode_tick_device_ms=tick_prof.get("device_ms"),
        k14_per_tick=tick_launches["grouped_matmul"],
        launches_k14=launches["grouped_matmul"],
        launches_k14_stream=k14_paths.get("stream", 0),
        launches_k14_mma=k14_paths.get("mma", 0),
        launches_flash=launches["flash_attention"],
        launches_decode=launches["decode_attention"],
        weights_gb=f"{weights_gb:.2f}", peak_memory_gb=f"{peak_gb:.2f}",
        init_s=f"{init_s:.1f}")
    say("5d full-width bf16 deepseek-v2-lite serve", **result)
    launches_k15 = k15_through_op(params, prefill, "prefill", "mma", mg,
                                  moe_mod, fa, da)
    tick_k15 = k15_through_op(params, decode, "decode tick", "stream", mg,
                              moe_mod, fa, da)
    launches_k15 = {"grouped_matmul_quantized": (
        launches_k15["grouped_matmul_quantized"]
        + tick_k15["grouped_matmul_quantized"])}
    del eng, tick_cache, params, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_moe": launches, "launches_k15": launches_k15,
            "moe_serve_lens": lens, "paths_moe": paths}


def k15_through_op(params, forward, what, path, mg, moe_mod, fa,
                   da) -> dict:
    """K15 on the main path's expert buffers: one ``forward`` (a prefill
    or a decode tick) in which each MoE layer's gate product (K14 on the
    bf16 gate weights) is also run through ``grouped_matmul_quantized``
    with the gate quantized to int8 per (expert, column).  K15's product
    is held to K14's within ``K15_PATH_REL_TOL`` of its largest |value|,
    and every K15 launch runs ``path`` (the weight stream at a decode
    tick's C = 8, the tile kernel at the prefill's C = 64)."""
    gates = {params["blocks"]["moe"]["gate"][i].data_ptr(): i
             for i in range(params["blocks"]["moe"]["gate"].shape[0])}
    real = moe_mod.gmm_ops.grouped_matmul
    errs, shapes = [], set()

    def both(x, w):
        y = real(x, w)
        if w.data_ptr() in gates:
            w_q, w_s = mg.quantize_expert_weights(w)
            yq = mg.grouped_matmul_quantized(x, w_q, w_s)
            errs.append(rel_err(yq, y) if bool(torch.isfinite(yq).all())
                        else float("inf"))
            shapes.add(tuple(x.shape))
            del w_q, w_s
        return y

    torch.cuda.synchronize()
    reset_counts(fa, da)
    # the MoE layer sees ``both`` through a stand-in for its ops module;
    # the wrapper itself (whose launch counter K14's launch reads) stays
    ops_module = moe_mod.gmm_ops
    moe_mod.gmm_ops = types.SimpleNamespace(grouped_matmul=both)
    try:
        forward()
    finally:
        moe_mod.gmm_ops = ops_module
    torch.cuda.synchronize()
    launches = read_counts(fa, da)
    paths = read_paths(fa, da).get("grouped_matmul_quantized", {})
    n = len(gates)
    expect(launches["grouped_matmul_quantized"] == n == len(errs)
           and paths == {path: n} and max(errs) <= K15_PATH_REL_TOL,
           f"K15 through its op ({what}): launches {launches}, by path "
           f"{paths}, relative errors {errs}")
    say(f"5d K15 through its op (int8 gate weights, every MoE layer of "
        f"the {what})", x_shapes="/".join(
            "x".join(map(str, sh)) for sh in sorted(shapes)),
        launches_k15=n, path=path,
        rel_err_vs_k14_max=f"{max(errs):.3g}",
        rel_err_vs_k14_mean=f"{float(np.mean(errs)):.3g}")
    return launches


def gmm_kernel_rows(mg, quant, gen, main_path, errs_gmm) -> list:
    """K14 and K15 at the decode shape of the gate / up products, [64, 8,
    2048] x [64, 2048, 1408] bf16 (K15 with int8 weights, both on the
    weight stream): 3 input sets of 369 MB (K15: 185 MB), each past the
    L2.  K14's library time is one ``torch.bmm`` on
    the same operands (the port never calls it); beside it, K14 at the
    down product and at the 488-token prefill (C = 64).  No PyTorch call
    multiplies by int8 weights with a column scale: beside K15 stands K14
    on the dequantized bf16 weights."""
    bf16, i8 = torch.bfloat16, torch.int8

    def stats(shape):
        e, c, d, f = shape
        sets = [gmm_inputs(gen, e, c, d, f, bf16) for _ in range(3)]
        ms = time_ms(mg.grouped_matmul, sets, iters=15)
        lib_ms = time_ms(torch.bmm, sets, iters=15)
        return sets, ms, lib_ms, 2 * e * c * d * f, 2 * (e * c * d
                                                        + e * d * f
                                                        + e * c * f)

    e, c, d, f = GMM_CASES["decode"]
    sets, ms, lib_ms, flops, nbytes = stats(GMM_CASES["decode"])
    plain_ms = time_ms(mg.grouped_matmul_plain, sets, iters=3)
    row = _row("grouped_matmul", "src/repro_torch/csrc/moe_gmm.cu",
               "src/repro/kernels/moe_gmm/kernel.py:41",
               main_path["launches_moe"]["grouped_matmul"],
               errs_gmm[("k14", bf16, "decode")], ms, plain_ms, flops,
               nbytes, lib_ms)
    qsets = []
    for x, w in sets:
        w_q, w_s = mg.quantize_expert_weights(w, dtype=i8)
        qsets.append((x, w_q, w_s))
    del sets
    for name in ("decode_down", "prefill"):
        extra, k_ms, k_lib, k_flops, k_bytes = stats(GMM_CASES[name])
        del extra
        row[f"{name}_ms"] = k_ms
        row[f"{name}_library_ms"] = k_lib
        t_ops = k_flops / PEAK_FLOPS[bf16] * 1e3
        row[f"{name}_bound_ms"] = max(t_ops, k_bytes / PEAK_BYTES * 1e3)
    rows = [row]
    ms = time_ms(mg.grouped_matmul_quantized, qsets, iters=15)
    plain_ms = time_ms(mg.grouped_matmul_quantized_plain, qsets, iters=3)
    deq = [(x, quant.dequantize(w_q, w_s).to(bf16)) for x, w_q, w_s in qsets]
    k14_ms = time_ms(mg.grouped_matmul, deq, iters=15)
    del deq
    # int8 weights and their f32 scales in, bf16 x in and out
    nbytes = e * d * f + 4 * e * f + 2 * (e * c * d + e * c * f)
    row = _row("grouped_matmul_quantized", "src/repro_torch/csrc/moe_gmm.cu",
               "src/repro/kernels/moe_gmm/kernel.py:104",
               main_path["launches_k15"]["grouped_matmul_quantized"],
               errs_gmm[("k15", i8, bf16, "decode")][0], ms, plain_ms, flops,
               nbytes, None)
    row["library"] = ("none: no PyTorch call multiplies by int8 weights "
                      "with a per-column scale")
    row["k14_dequantized_ms"] = k14_ms
    rows.append(row)
    del qsets
    return rows


def mla_attention_fields(fa, da, gen, main_path, errs_mla) -> tuple:
    """K1 at the MLA prefill pair (B=1, Sq = Skv = 488, 16 heads, Dk 192,
    Dv 128, causal) and K2 at the absorbed decode's (B=8, S=1024, one
    latent KV head, G=16, Dk 576, Dv 512, at the served lengths mid-way
    through decode): ms, bound, plain ms, library ms (one
    ``scaled_dot_product_attention`` call: K and V per head, V of its own
    width) and the launches of the deepseek serve, as extra fields of the
    K1 and K2 rows."""
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launches = main_path["launches_moe"]
    b, s, h, dk, dv = 1, 488, 16, 192, 128
    sets = [(randn(gen, (b, s, h, dk), bf16), randn(gen, (b, s, h, dk), bf16),
             randn(gen, (b, s, h, dv), bf16)) for _ in range(16)]
    ms = time_ms(lambda q, k, v: fa.flash_attention(q, k, v), sets)
    plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(q, k, v),
                       sets, iters=5)
    lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
    lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True), lib_sets)
    pairs = s * (s + 1) // 2
    flops = 2 * (dk + dv) * h * b * pairs
    nbytes = 2 * (b * s * h * (2 * dk + 2 * dv)) + 4 * b * h * s
    k1 = _row("", "", "", launches["flash_attention"],
              errs_mla[("k1", bf16, "prefill")], ms, plain_ms, flops, nbytes,
              lib_ms)
    del sets, lib_sets
    b, s, g, dk, dv = 8, 1024, 16, 576, 512
    kv_len = torch.tensor(np.minimum(main_path["moe_serve_lens"][:8] + 16, s),
                          dtype=torch.int32, device="cuda")
    sets = [(*mla_decode_inputs(gen, b, s, g, dk, dv, bf16), kv_len)
            for _ in range(4)]
    ms = time_ms(da.decode_attention, sets)
    plain_ms = time_ms(da.decode_attention_plain, sets, iters=10)
    mask = (torch.arange(s, device="cuda")[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v, _ in sets]
    lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask,
                                          enable_gqa=True), lib_sets)
    live = int(kv_len.sum())
    flops = 2 * (dk + dv) * g * live
    nbytes = 2 * (live * (dk + dv) + b * g * (dk + dv)) + 4 * b
    k2 = _row("", "", "", launches["decode_attention"],
              errs_mla[("k2", bf16, "decode")], ms, plain_ms, flops, nbytes,
              lib_ms)
    del sets, lib_sets
    keep = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    k1["path"] = PATHS[bf16]
    return ({f"mla_{k}": k1[k] for k in keep + ("path",)},
            {f"mla_{k}": k2[k] for k in keep})


# --------------------------------------------------------- phases 2x, 4x, 5x

ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "llama-3.2-vision-11b"
CROSS_GATE = 0.5          # the vision family's cross gates (0 at init)
# 5x: zeroing the frames or patches must move the first-token logits by
# more than this share of the largest logit.  A cross path that ignores
# its input (patches dropped, a cache left at its zeros) reads exactly 0:
# both prefills are then the same computation.  At full width seamless
# reads 1.43 and llama-vision 0.0152 (its cross blocks are 8 of 40, gated
# by tanh(0.5)), so a tenth of the smaller keeps room on both sides.
MODAL_MOVED_MIN = 1e-3
# b, sq, skv, kv_len, q_offset, causal, hq, hkv, d of K1's calls in the
# two families' prefills and generate() ticks: seamless's encoder over its
# 128 frames; its decoder's causal self-attention over the 1,024-row cache
# at a 512-token prefill and at a tick (one query, the scalar kv_len and
# q_offset that attention.py passes after 512 tokens); its cross-attention
# over the frames at a prefill and at a tick; llama-vision's self blocks
# (32 on 8 heads of 128, G = 4) at the same prefill and tick, and its
# cross-attention over the 1,601 patch rows at a prefill and at a tick
CASES_2X = {
    "encdec_encoder": (8, 128, 128, None, None, False, 16, 16, 64),
    "encdec_self": (8, 512, 1024, 512, 0, True, 16, 16, 64),
    "encdec_self_tick": (8, 1, 1024, 513, 512, True, 16, 16, 64),
    "encdec_cross": (8, 512, 128, None, None, False, 16, 16, 64),
    "encdec_cross_tick": (8, 1, 128, None, None, False, 16, 16, 64),
    "vlm_self": (8, 512, 1024, 512, 0, True, 32, 8, 128),
    "vlm_self_tick": (8, 1, 1024, 513, 512, True, 32, 8, 128),
    "vlm_cross": (8, 512, 1601, None, None, False, 32, 8, 128),
    "vlm_cross_tick": (8, 1, 1601, None, None, False, 32, 8, 128)}


def check_encdec_vlm_attention(fa, da, gen) -> dict:
    """2x: K1 against its plain version at ``CASES_2X``, bf16 and f32: the
    shapes phase 2 does not cover (G = 1 at D = 64, G = 4 at D = 128,
    causal over a 1,024-row cache with a scalar kv_len, non-causal with no
    kv_len, a KV tail of 1,601 mod 64 = 1 row, one query row against a
    whole cache).  Every bf16 launch must run ``mma``."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        reset_counts(fa, da)
        for case, (b, sq, skv, kv_len, q_offset, causal, hq, hkv,
                   d) in CASES_2X.items():
            q = randn(gen, (b, sq, hq, d), dtype)
            k = randn(gen, (b, skv, hkv, d), dtype)
            v = randn(gen, (b, skv, hkv, d), dtype)
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          kv_len=kv_len, q_offset=q_offset)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_plain(
                q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset)
            err = max_err(out, ref)
            expect(out.shape == (b, sq, hq, d) and err <= TOL[dtype]
                   and max_err(lse, ref_lse) <= 1e-3,
                   f"K1 {dtype} {case}: err {err}")
            errs[(case, dtype)] = err
        paths = read_paths(fa, da)
        expect(paths == {"flash_attention": {
            PATHS[dtype]: len(CASES_2X)}},
               f"K1 {dtype} 2x cases: launches by path {paths}")
    say("2x K1 at the encoder-decoder and vision shapes vs plain",
        bf16_path=PATHS[torch.bfloat16], **{
            f"{case}_{str(dt)[6:]}": f"{e:.3g}"
            for (case, dt), e in errs.items()})
    return errs


def gate_cross(params, value: float = CROSS_GATE):
    """Set the vision family's cross gates (``tanh(0) = 0`` at init would
    leave the cross path out) in place; returns ``params``."""
    if "groups" in params:
        for name in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][name].fill_(value)
    return params


def attention_calls(cfg, prefill: bool) -> int:
    """K1 launches of a prefill or a tick: the vision family's groups of
    self blocks and one cross block; the encoder-decoder family's
    self- and cross-attention a decoder layer, its encoder layers at a
    prefill."""
    if cfg.family == "vlm":
        return cfg.cross_attn_groups * (cfg.self_per_group + 1)
    return 2 * cfg.n_layers + (cfg.n_encoder_layers if prefill else 0)


def reduced_card_vs_cpu(cpu, gpu, params_cpu, params_gpu, batch_cpu,
                        batch_gpu, max_len, rng, fa, da) -> dict:
    """A reduced f32 model's prefill of ``batch_*`` and 3 decode steps of
    tokens drawn from ``rng``, on the CPU (the plain versions) and on the
    card: the largest logit error of the prefill and of the steps, the
    largest relative error of a cache leaf after the prefill and after
    the last step, and the card's launches (nonzero counts) of each
    call."""
    from repro_torch.checkpoint.checkpoint import flatten

    def cache_err(cg, cc):
        got = flatten(cg)
        return max(rel_err(got[path].float().cpu(), leaf.float())
                   for path, leaf in flatten(cc).items())

    def launched():
        torch.cuda.synchronize()
        return {n: c for n, c in read_counts(fa, da).items() if c}

    lc, cc = cpu.prefill(params_cpu, batch_cpu, max_len, torch.float32)
    torch.cuda.synchronize()
    reset_counts(fa, da)
    lg, cg = gpu.prefill(params_gpu, batch_gpu, max_len, torch.float32)
    counts = [launched()]
    errs = {"prefill": max_err(lg.cpu(), lc), "decode": 0.0,
            "cache": cache_err(cg, cc)}
    for _ in range(3):
        nxt = rng.randint(1, gpu.cfg.vocab_size,
                          (lc.shape[0], 1)).astype(np.int32)
        dc, cc = cpu.decode_step(params_cpu, nxt, cc)
        torch.cuda.synchronize()
        reset_counts(fa, da)
        dg, cg = gpu.decode_step(params_gpu, nxt, cg)
        counts.append(launched())
        errs["decode"] = max(errs["decode"], max_err(dg.cpu(), dc))
    errs["cache"] = max(errs["cache"], cache_err(cg, cc))
    return dict(errs, counts=counts)


# the full models' head shapes at the reduced width: seamless's 64-wide
# heads at G = 1, llama-vision's 128-wide heads at G = 4
FULL_HEADS = {ENCDEC_ARCH: dict(head_dim=64, n_heads=4, n_kv_heads=4),
              VLM_ARCH: dict(head_dim=128, n_heads=8, n_kv_heads=2)}


def check_reduced_encdec_vlm(get_config, Model, Engine, ServeConfig,
                             make_dummy_batch, fa, da) -> None:
    """4x: the reduced f32 seamless-m4t and llama-vision at the full
    models' head shapes (``FULL_HEADS``; 2 + 2 encoder-decoder layers, 2
    groups of a self and a gated cross block over 16 patch rows; gates
    0.5) on the card (K1) against the CPU (its plain version): first-token
    and 3 decode steps' logits, every cache leaf, 6 greedy ``generate``
    tokens; K1 launched once per attention call of each prefill and tick,
    and no other kernel."""
    fields = {}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  **FULL_HEADS[arch])
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        params_cpu = gate_cross(cpu.init(SEED))
        params_gpu = to_device(params_cpu, "cuda")
        batch_cpu = make_dummy_batch(cfg, 2, 24, SEED, device="cpu")
        batch_gpu = to_device(batch_cpu, "cuda")
        errs = reduced_card_vs_cpu(cpu, gpu, params_cpu, params_gpu,
                                   batch_cpu, batch_gpu, 64,
                                   np.random.RandomState(SEED), fa, da)
        got = errs["counts"]
        want = [{"flash_attention": attention_calls(cfg, i == 0)}
                for i in range(len(got))]
        out_cpu = Engine(cpu, params_cpu, ServeConfig(max_len=64)).generate(
            batch_cpu, 6)
        out_gpu = Engine(gpu, params_gpu, ServeConfig(max_len=64)).generate(
            batch_gpu, 6)
        same = bool(np.array_equal(out_cpu, out_gpu))
        expect(errs["prefill"] <= LOGIT_TOL and errs["decode"] <= LOGIT_TOL
               and errs["cache"] <= LOGIT_TOL and same and got == want,
               f"reduced {arch}: prefill {errs['prefill']}, decode "
               f"{errs['decode']}, cache {errs['cache']}, tokens equal "
               f"{same}, launches {got} (want {want})")
        tag = cfg.family
        fields.update({f"{tag}_head_dim": cfg.head_dim,
                       f"{tag}_heads": f"{cfg.n_heads}/{cfg.n_kv_heads}",
                       f"{tag}_prefill_logit_err": f"{errs['prefill']:.3g}",
                       f"{tag}_decode_logit_err": f"{errs['decode']:.3g}",
                       f"{tag}_cache_rel_err": f"{errs['cache']:.3g}",
                       f"{tag}_tokens_equal_cpu": same,
                       f"{tag}_k1_prefill": got[0]["flash_attention"],
                       f"{tag}_k1_tick": got[1]["flash_attention"]})
    say("4x reduced f32 seamless-m4t and llama-vision card vs cpu", **fields)


def modal_key(cfg) -> str:
    return "patches" if cfg.family == "vlm" else "frames"


def generate_full_width(arch, get_config, Model, Engine, ServeConfig,
                        make_dummy_batch, fa, da) -> dict:
    """5x for one configuration at full width in bf16 (weights from the
    seed, gates 0.5): ``generate`` on 8 rows of 512 prompt tokens and the
    modal input (seamless: frames [8, 128, 1024]; llama-vision: patches [8,
    1601, 4096]), 32 new tokens, ``max_len`` 1024, after the earlier
    tensors are freed: K1 alone launched, 72 times a prefill and 48 a tick
    (seamless), 40 and 40 (llama-vision), all on ``mma``; greedy tokens
    equal across two calls; decode steps 1-4 against one prefill over the
    prompt and the tokens generated so far within ``HIT_LOGIT_REL_TOL``;
    zeroing the frames or patches moves the first-token logits
    (``MODAL_MOVED_MIN``); ``serve()``, an int8 cache and ``lengths``
    refused.  Printed: a temperature 0.8 ``generate(seed, rids)``'s
    tokens/s, a profiled prefill and tick, the peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bf16 = torch.bfloat16
    cfg = get_config(arch).with_dtype("bfloat16")
    model = Model(cfg, device="cuda")
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = gate_cross(model.init(SEED))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_gb = (torch.cuda.memory_allocated() - before) / 1e9
    batch = make_dummy_batch(cfg, 8, 512, SEED)
    key = modal_key(cfg)
    n_new, max_len = 32, 1024
    scfg = ServeConfig(max_len=max_len, cache_dtype="bfloat16")
    eng = Engine(model, params, scfg)
    eng.generate(batch, 2)                         # warm-up (cuBLAS)
    torch.cuda.synchronize()
    reset_counts(fa, da)
    t0 = time.perf_counter()
    out = eng.generate(batch, n_new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, paths = read_counts(fa, da), read_paths(fa, da)
    k1_prefill, k1_tick = attention_calls(cfg, True), attention_calls(cfg,
                                                                      False)
    want = {"flash_attention": k1_prefill + n_new * k1_tick}
    expect({n: c for n, c in launches.items() if c} == want
           and on_path(paths, want, "mma"),
           f"{arch} generate: launches {launches} (want {want}), by path "
           f"{paths}")
    expect(out.shape == (8, n_new) and bool(((out >= 0)
                                             & (out < cfg.vocab_size)).all()),
           f"{arch} generate: malformed tokens")
    again = eng.generate(batch, n_new)
    expect(np.array_equal(out, again), f"{arch} generate: greedy tokens "
           f"differ between two calls")
    # prefill / decode consistency, and the launches of one prefill and
    # one tick
    reset_counts(fa, da)
    logits, cache = model.prefill(params, batch, max_len, bf16)
    torch.cuda.synchronize()
    prefill_counts = {n: c for n, c in read_counts(fa, da).items() if c}
    toks = batch["tokens"]
    tok = torch.argmax(logits, -1)
    consistency = []
    tick_counts = None
    for j in range(1, 5):
        reset_counts(fa, da)
        step, cache = model.decode_step(params, tok[:, None], cache)
        torch.cuda.synchronize()
        if tick_counts is None:
            tick_counts = {n: c for n, c in read_counts(fa, da).items() if c}
        toks = torch.cat([toks, tok[:, None].to(toks.dtype)], 1)
        ref, _ = model.prefill(params, dict(batch, tokens=toks), max_len, bf16)
        consistency.append(max_err(step, ref) / ref.abs().max().item())
        tok = torch.argmax(step, -1)
        del ref
    expect(prefill_counts == {"flash_attention": k1_prefill}
           and tick_counts == {"flash_attention": k1_tick},
           f"{arch}: launches a prefill {prefill_counts}, a tick "
           f"{tick_counts} (want {k1_prefill}, {k1_tick})")
    expect(max(consistency) <= HIT_LOGIT_REL_TOL,
           f"{arch}: decode steps 1-4 against a prefill over the same "
           f"tokens {consistency}")
    zeroed, _ = model.prefill(params, dict(batch, **{
        key: torch.zeros_like(batch[key])}), max_len, bf16)
    moved = max_err(logits, zeroed) / logits.abs().max().item()
    expect(moved > MODAL_MOVED_MIN, f"{arch}: zeroing the {key} moved the "
           f"first-token logits by {moved} of the largest")
    del zeroed
    refused = {}
    for what, call in (
            ("serve", lambda: eng.serve([np.arange(1, 9, dtype=np.int32)],
                                        2)),
            ("int8", lambda: Engine(model, params, ServeConfig(
                max_len=max_len, kv_dtype="int8")).generate(batch, 1)),
            ("lengths", lambda: eng.generate(
                batch, 1, lengths=np.full(8, 512)))):
        try:
            call()
        except ValueError:
            refused[what] = True
    expect(set(refused) == {"serve", "int8", "lengths"},
           f"{arch}: refusals {refused}")
    # printed, not checked: a temperature 0.8 generate, profiles, memory
    eng_t = Engine(model, params, dataclasses.replace(scfg, temperature=0.8))
    eng_t.generate(batch, 2, seed=SEED, rids=range(100, 108))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampled = eng_t.generate(batch, n_new, seed=SEED, rids=range(100, 108))
    torch.cuda.synchronize()
    sampled_s = time.perf_counter() - t0
    prof = {"prefill": profile(
        lambda: model.prefill(params, batch, max_len, bf16), 3)}
    tick = tok[:, None]
    prof["tick"] = profile(lambda: model.decode_step(params, tick, cache), 10)
    for what, p in prof.items():
        say(f"5x profile {arch} {what}", **p)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    result = dict(
        weights_gb=f"{weights_gb:.2f}", init_s=f"{init_s:.1f}",
        modal=f"{key}{list(batch[key].shape)}",
        greedy_tokens_per_s=f"{out.size / wall_s:.1f}",
        greedy_wall_s=f"{wall_s:.3f}", deterministic=True,
        k1_prefill=prefill_counts.get("flash_attention"),
        k1_tick=tick_counts.get("flash_attention"),
        k1_generate=launches["flash_attention"],
        consistency_rel=",".join(f"{c:.3g}" for c in consistency),
        modal_moves_logits=f"{moved:.3g}",
        sampled_tokens_per_s=f"{sampled.size / sampled_s:.1f}",
        sampled_distinct_from_greedy=int((sampled != out).sum()),
        peak_gb=f"{peak_gb:.2f}",
        prefill_device_ms=prof["prefill"].get("device_ms"),
        prefill_k1_ms=prof["prefill"].get("k1_ms"),
        tick_wall_ms=prof["tick"]["wall_ms"],
        tick_device_ms=prof["tick"].get("device_ms"),
        tick_k1_ms=prof["tick"].get("k1_ms"),
        refused=",".join(refused))
    say(f"5x full-width bf16 {arch} generate", **result)
    del eng, eng_t, cache, params, model, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "k1_prefill": k1_prefill,
            "k1_tick": k1_tick}


def cross_attention_fields(fa, da, gen, main_path, errs_2x) -> dict:
    """K1 at 5x's cross-attention shapes, a prefill's (8 rows of 512
    queries over the 128 frames or the 1,601 patch rows) and a tick's (one
    query a row): ms, bound, plain ms, one non-causal SDPA call's ms, and
    the launches of 5x's ``generate``, as ``encdec_*`` and ``vlm_*``
    fields of the K1 row.  The vision tick's fields add K2's ms on the
    same rows with a [B] ``kv_len`` of 1,601 (the decode kernel a tick's
    cross call could take; not on the path)."""
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, arch in (("encdec", ENCDEC_ARCH), ("vlm", VLM_ARCH)):
        launches = main_path[f"launches_{arch}"]["launches"]
        out[f"{tag}_launches"] = launches["flash_attention"]
        for case in ("cross", "cross_tick"):
            b, sq, skv, _, _, _, hq, hkv, d = CASES_2X[f"{tag}_{case}"]
            sets = [(randn(gen, (b, sq, hq, d), bf16),
                     randn(gen, (b, skv, hkv, d), bf16),
                     randn(gen, (b, skv, hkv, d), bf16)) for _ in range(8)]
            ms = time_ms(lambda q, k, v: fa.flash_attention(
                q, k, v, causal=False), sets)
            plain_ms = time_ms(lambda q, k, v: fa.flash_attention_plain(
                q, k, v, causal=False), sets, iters=5)
            lib_sets = [tuple(t.transpose(1, 2) for t in st) for st in sets]
            lib_ms = time_ms(lambda q, k, v: sdpa(q, k, v, enable_gqa=True),
                             lib_sets)
            flops = 4 * d * hq * b * sq * skv
            nbytes = (2 * 2 * b * sq * hq * d + 2 * 2 * b * skv * hkv * d
                      + 4 * b * hq * sq)
            row = _row("", "", "", launches["flash_attention"],
                       errs_2x[(f"{tag}_{case}", bf16)], ms, plain_ms,
                       flops, nbytes, lib_ms)
            name = f"{tag}_{case.replace('cross_', '')}"
            out.update({f"{name}_{k}": row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
            if tag == "vlm" and sq == 1:
                kv_len = torch.full((b,), skv, dtype=torch.int32,
                                    device="cuda")
                out[f"{name}_k2_ms"] = time_ms(
                    lambda q, k, v: da.decode_attention(q[:, 0], k, v,
                                                        kv_len), sets)
            del sets, lib_sets
    return out


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
    from repro_torch.configs.inputs import make_dummy_batch
    from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                           SyntheticLM)
    from repro_torch.kernels import _build, quant
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_ssd import ops as ss
    from repro_torch.kernels.moe_gmm import ops as mg
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.attention import naive_attention
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    # every phase but 5t runs the analytic (classic) kernel choices: no
    # tuning db, wherever one lies, changes them; 5t's db lives in build/
    os.environ["REPRO_TUNING"] = "off"
    # every phase runs the default tuning context: no calibration that an
    # earlier run persisted moves an admission block or a kernel prior;
    # phase 8 installs its calibrated contexts in memory only
    os.environ["REPRO_CALIBRATION"] = "off"
    db_path = _build.BUILD / "tuning_db_torch.json"
    os.environ["REPRO_TORCH_TUNING_DB"] = str(db_path)
    t_start = time.monotonic()
    gpu = card()
    db_path.unlink(missing_ok=True)
    for name in KERNELS:                   # build from this checkout's sources
        _build.library_path(name).unlink(missing_ok=True)
    build_s = _build.build(KERNELS)
    mma, spilled = tensor_core_spills(_build.BUILD / "libflash_attention.log")
    say("1 device and build", card=f"'{gpu}'", build_s=f"{build_s:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda,
        flash_mma_kernels=mma, flash_mma_spill_bytes=spilled,
        **{f"build_s_{n}": f"{t:.1f}" for n, t in
           _build.BUILD_SECONDS.items()})
    for lib, kernel in (("decode_attention", "decode_split_mma_kernel"),
                        ("decode_attention", "decode_split_quant_mma_kernel"),
                        ("moe_gmm", "gmm_stream_kernel"),
                        ("mamba_ssd", "ssd_mma_kernel"),
                        ("flash_attention", "fa_fwd_quant_mma_kernel")):
        report = ptxas_report(_build.BUILD / f"lib{lib}.log", kernel)
        expect(report and all(sp == 0 for _, sp in report.values()),
               f"{kernel}: ptxas reports {report}")
        say(f"1 ptxas {kernel} (registers, spill bytes)",
            instances=len(report),
            **{k: f"{r}r/{sp}" for k, (r, sp) in report.items()})
    # the head_dim 80 instances of the tensor-core attention kernels
    d80 = {}
    for lib, kernel in (("flash_attention", "fa_fwd_mma_kernel"),
                        ("flash_attention", "fa_fwd_quant_mma_kernel"),
                        ("decode_attention", "decode_split_mma_kernel"),
                        ("decode_attention", "decode_split_quant_mma_kernel")):
        report = ptxas_report(_build.BUILD / f"lib{lib}.log", kernel)
        d80.update({f"{kernel}:{k}": v for k, v in report.items()
                    if str(D80) in k.split("/")})
    expect({k.split(":")[0] for k in d80} == {
        "fa_fwd_mma_kernel", "fa_fwd_quant_mma_kernel",
        "decode_split_mma_kernel", "decode_split_quant_mma_kernel"}
           and all(sp == 0 for _, sp in d80.values()),
           f"head_dim 80 instances: ptxas reports {d80}")
    say("1 ptxas head_dim 80 instances (registers, spill bytes)",
        instances=len(d80), **{k: f"{r}r/{sp}" for k, (r, sp) in d80.items()})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs_fa = check_flash(fa, gen)
    errs_da = check_decode(da, gen)
    check_mma_decode(da, gen)
    errs_pa = check_paged_decode(da, gen)
    errs_q = check_quantized(fa, da, quant, gen)
    errs_p = check_pipelined(fa, da, quant, gen)
    errs_bwd = check_flash_bwd(fa, naive_attention, gen)
    errs_ssd = check_ssd(ss, quant, gen)
    errs_gmm = check_gmm(mg, quant, gen)
    errs_mla = check_mla_attention(fa, da, gen)
    errs_d80 = check_d80(fa, da, quant, gen)
    errs_2x = check_encdec_vlm_attention(fa, da, gen)
    check_reduced_model(get_config, Model, Engine, ServeConfig)
    check_reduced_bf16_int8(get_config, Model, fa, da)
    check_reduced_ssm(get_config, Model, Engine, ServeConfig, fa, da)
    check_reduced_training(get_config, Model, opt, make_train_step,
                           DataConfig, SyntheticLM, launch_train, fa)
    check_reduced_moe(get_config, Model, Engine, ServeConfig, fa, da, mg)
    check_reduced_hybrid(get_config, Model, Engine, ServeConfig, fa, da)
    check_reduced_sampled(get_config, Model, Engine, ServeConfig)
    check_reduced_encdec_vlm(get_config, Model, Engine, ServeConfig,
                             make_dummy_batch, fa, da)
    main_path = serve_full_width(get_config, Model, Engine, ServeConfig,
                                 fa, da)
    main_path.update(serve_ssm_full_width(get_config, Model, Engine,
                                          ServeConfig, fa, da, ss, quant))
    main_path.update(serve_hybrid_full_width(get_config, Model, Engine,
                                             ServeConfig, fa, da))
    check_full_width_gradient(get_config, Model, DataConfig, SyntheticLM,
                              fa)
    main_path.update(train_full_width(
        get_config, Model, opt, make_train_step, DataConfig, SyntheticLM,
        PrefetchIterator, fa, da))
    calibrate_on_host()
    main_path.update(serve_moe_full_width(get_config, Model, Engine,
                                          ServeConfig, fa, da, mg, quant))
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        main_path[f"launches_{arch}"] = generate_full_width(
            arch, get_config, Model, Engine, ServeConfig, make_dummy_batch,
            fa, da)
    qwen, zamba = row_shapes(main_path, errs_fa, errs_da, errs_pa, errs_q,
                             errs_p, errs_d80)
    rows = kernel_rows(fa, da, gen, qwen)
    mla_k1, mla_k2 = mla_attention_fields(fa, da, gen, main_path, errs_mla)
    rows[0].update(mla_k1)
    rows[1].update(mla_k2)
    rows[0].update(cross_attention_fields(fa, da, gen, main_path,
                                          errs_2x))
    rows += quant_kernel_rows(fa, da, quant, gen, qwen)
    rows += pipelined_kernel_rows(fa, da, quant, gen, qwen)
    rows.append(bwd_kernel_row(fa, gen, main_path, errs_bwd))
    rows += ssd_kernel_rows(ss, quant, gen, main_path, errs_ssd)
    rows += gmm_kernel_rows(mg, quant, gen, main_path, errs_gmm)
    # zamba2's head shape (D = 80, G = 1) beside each of K1-K10, as d80_*
    # fields of their rows
    d80 = {r["name"]: r for r in (
        kernel_rows(fa, da, gen, zamba)
        + quant_kernel_rows(fa, da, quant, gen, zamba)
        + pipelined_kernel_rows(fa, da, quant, gen, zamba))}
    torch.cuda.empty_cache()
    for r in rows:
        if r["name"] in d80:
            r.update({f"d80_{k}": v for k, v in d80.pop(r["name"]).items()
                      if k not in ("name", "route", "source", "replaces",
                                   "library")})
    expect(not d80, f"D=80 rows without a row to join: {sorted(d80)}")
    # launches of the speculative serves (phase 5s): self drafter,
    # contiguous (K1, K2: target and drafter), paged (K3: the verify) and
    # int8 (K10, K7)
    spec_launches = {
        name: main_path[key][name] for key, name in (
            ("launches_spec", "flash_attention"),
            ("launches_spec", "decode_attention"),
            ("launches_spec_paged", "paged_decode_attention"),
            ("launches_spec_int8", "flash_attention_quantized"),
            ("launches_spec_int8", "decode_attention_quantized"))}
    for r in rows:
        if r["name"] in spec_launches:
            r["spec_launches"] = spec_launches[r["name"]]
    # K1 in phase 7d's selective-remat step (K11's row carries its own)
    rows[0]["train_dots_launches"] = \
        main_path["launches_train_dots"]["flash_attention"]
    # the library path of the bf16 calls each row times
    for r in rows:
        if r["name"] in ("decode_attention", "paged_decode_attention",
                         "decode_attention_pipelined",
                         "paged_decode_attention_pipelined",
                         "decode_attention_quantized",
                         "paged_decode_attention_quantized",
                         "paged_decode_attention_quantized_pipelined"):
            r["path"] = "mma"
        elif r["name"] in ("grouped_matmul", "grouped_matmul_quantized"):
            r.update(path="stream", prefill_path="mma")
    for r in rows:
        say("6 kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                           for k, v in r.items()
                           if k not in ("route", "source", "replaces",
                                        "library")})
    say("done", total_s=f"{time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
