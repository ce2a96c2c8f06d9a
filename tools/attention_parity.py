#!/usr/bin/env python3
"""Outputs and times of the port's attention, scan and expert-matmul
kernels at the serve and training paths' shapes, for holding one tree's
kernels to another's on the card.

    PYTHONPATH=<tree>/src python3 tools/attention_parity.py dump OUT.pt
    python3 tools/attention_parity.py compare A.pt B.pt [C.pt ...]

``dump`` imports ``repro_torch`` from the path given (so it builds and
runs that tree's kernels), feeds K1, K4 (depths 2 and 4), K2, K3, K5 and
K6 (depths 2 and 4), K7, K8, K9 (depths 2 and 4), K10 (int8 and e4m3
caches), K11, K12, K13 (int8 and e4m3 x), K14 and K15 the same inputs
drawn from a CPU generator seeded with 0 (the shapes of
``chip_smoke.py``'s kernel rows; K12 and K13 at the longest served
prompt, 488 tokens, K12 with an initial state; K14 at the decode gate /
up and down products and at a 64-row prefill, K15 with int8 weights at
the decode gate / up product), first in bf16 and then every one of them
but K4 (the f32 forward has no ring) and K14's down and prefill products
again in f32 (K7-K9 with f32 queries, K15 with f32 x), and saves each
output (K1, K4 and K10: out and
lse; K11: dq, dk, dv; K12 and K13: y and the final state) with its device
ms per call (CUDA events around 30 calls on the same inputs, L2-warm,
after a warm-up) and whether each ring equals its classic kernel bit for
bit in that tree (K4 == K1, K5 == K2, K6 == K3, K9 == K8, in both
dtypes).

``compare`` prints, for each kernel, whether every dump's output equals
the first one's bit for bit, the largest difference and the times side by
side.  The bf16 kernels that moved to the tensor cores (K1, K4, K11; K2,
K3, K5, K6; K14 at decode; K10, K12, K13; K7, K8, K9 and K15 at decode)
may change between trees when their kernels do (the tensor-core paths
round p, ds and the scan's decay-weighted scores to bf16 where the
CUDA-core ones kept f32, and sum in another order): those are held to the
card tests' tolerances against the first dump instead (attention out
2e-2, lse 1e-3, each gradient 1e-2 of its largest |value|, K14 and K15
1e-2 of their largest |value|, the scan's y 1e-2 and its f32 state 1e-5
of their largest |value|).  Every other output must be bit-equal; ``compare`` exits
non-zero if one is not, or if a tolerance is missed.  Run the dumps of
two trees in turns (A, B, B, A) in one call on one card.
"""

from __future__ import annotations

import sys

import torch

# bf16 outputs held to a tolerance between trees: (absolute on out, on lse)
# for the forward, relative to each gradient's largest |value| for K11
FWD_TOL = (2e-2, 1e-3)
BWD_REL_TOL = 1e-2
GMM_REL_TOL = 1e-2
SSD_REL_TOL = (1e-2, 1e-5)      # y, the f32 final state
TOLERANT = {"K1", "K4d2", "K4d4", "K11", "K2", "K3", "K5d2", "K5d4", "K6d2",
            "K6d4", "K14", "K14d", "K10", "K10e", "K12", "K13", "K13e",
            "K7", "K8", "K9d2", "K9d4", "K15"}
# each ring and the classic kernel it must equal bit for bit in a tree
RINGS = {"K4d2": "K1", "K4d4": "K1", "K5d2": "K2", "K5d4": "K2",
         "K6d2": "K3", "K6d4": "K3", "K9d2": "K8", "K9d4": "K8"}


def _inputs(dtype):
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype).cuda()

    kv_len = torch.tensor([489, 117, 1024, 1024, 353, 40, 300, 777],
                          dtype=torch.int32).cuda()
    pages = torch.randperm(512, generator=gen).reshape(8, 64).to(
        torch.int32).cuda() + 1
    return {
        "prefill": (randn(1, 512, 16, 128), randn(1, 1024, 2, 128),
                    randn(1, 1024, 2, 128)),
        "decode": (randn(8, 16, 128), randn(8, 1024, 2, 128),
                   randn(8, 1024, 2, 128), kv_len),
        "pool": (randn(513, 16, 2, 128), randn(513, 16, 2, 128), pages),
        "train": (randn(2, 1024, 16, 128), randn(2, 1024, 2, 128),
                  randn(2, 1024, 2, 128), randn(2, 1024, 16, 128)),
        "gmm": (randn(64, 8, 2048), randn(64, 2048, 1408) / 2048 ** 0.5),
        "gmm_down": (randn(64, 8, 1408), randn(64, 1408, 2048) / 1408 ** 0.5),
        "gmm_prefill": (randn(64, 64, 2048),
                        randn(64, 2048, 1408) / 2048 ** 0.5),
        # x, dt, a, B, C and an initial state of a 488-token mamba2 prefill
        "ssd": (randn(1, 488, 48, 64),
                torch.nn.functional.softplus(
                    torch.randn((1, 488, 48), generator=gen)).cuda(),
                -torch.exp(torch.randn((48,), generator=gen)).cuda(),
                randn(1, 488, 1, 128), randn(1, 488, 1, 128),
                torch.randn((1, 48, 64, 128), generator=gen).cuda()),
    }


def _ms(fn, iters: int = 30) -> float:
    """Device ms per call; the stream is first held by a ~0.1 s sleep
    kernel while the calls are queued, so the host's launch time does not
    show as gaps between them (as ``chip_smoke.time_ms`` does)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _calls(dtype) -> dict:
    from repro_torch.kernels import quant
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_ssd import ops as ss
    from repro_torch.kernels.moe_gmm import ops as mg

    x = _inputs(dtype)
    q, k, v = x["prefill"]
    qd, kd, vd, kl = x["decode"]
    kp, vp, pt = x["pool"]
    qt, kt, vt, dout = x["train"]
    xg, wg = x["gmm"]
    xd, wd = x["gmm_down"]
    xp, wp = x["gmm_prefill"]
    xs, dts, a_s, bs, cs, init = x["ssd"]
    out_t, lse_t = fa.flash_attention(qt, kt, vt)

    def quantized(t, store):
        return quant.quantize(t, dtype=store, scale_dtype=quant.SCALE_DTYPE)

    (kq, ks), (vq, vs) = (quantized(t, torch.int8) for t in (k, v))
    (ke, kes), (ve, ves) = (quantized(t, torch.float8_e4m3fn) for t in (k, v))
    xq, xqs = quantized(xs, torch.int8)
    xe, xes = quantized(xs, torch.float8_e4m3fn)

    def k4(depth):
        return lambda: fa.flash_attention_pipelined(
            q, k, v, kv_len=512, q_offset=0, num_buffers=depth)

    def k5(depth):
        return lambda: da.decode_attention_pipelined(qd, kd, vd, kl,
                                                     num_buffers=depth)

    def k6(depth):
        return lambda: da.paged_decode_attention_pipelined(
            qd, kp, vp, pt, kl, num_buffers=depth)

    calls = {
        "K1": lambda: fa.flash_attention(q, k, v, kv_len=512, q_offset=0),
        "K4d2": k4(2),
        "K4d4": k4(4),
        "K2": lambda: da.decode_attention(qd, kd, vd, kl),
        "K3": lambda: da.paged_decode_attention(qd, kp, vp, pt, kl),
        "K5d2": k5(2),
        "K5d4": k5(4),
        "K6d2": k6(2),
        "K6d4": k6(4),
        "K11": lambda: fa.flash_attention_bwd(qt, kt, vt, out_t, lse_t,
                                              dout),
        "K14": lambda: mg.grouped_matmul(xg, wg),
        "K10": lambda: fa.flash_attention_quantized(
            q, kq, ks, vq, vs, kv_len=512, q_offset=0),
        "K10e": lambda: fa.flash_attention_quantized(
            q, ke, kes, ve, ves, kv_len=512, q_offset=0),
        "K12": lambda: ss.ssd(xs, dts, a_s, bs, cs, initial_state=init),
        "K13": lambda: ss.ssd_quantized(xq, xqs, dts, a_s, bs, cs),
        "K13e": lambda: ss.ssd_quantized(xe, xes, dts, a_s, bs, cs),
    }

    def q8(t):
        return quantized(t, torch.int8)

    (kdq, kds), (vdq, vds) = q8(kd), q8(vd)
    (kpq, kps), (vpq, vps) = q8(kp), q8(vp)
    wq, ws = mg.quantize_expert_weights(wg)

    def k9(depth):
        return lambda: da.paged_decode_attention_quantized_pipelined(
            qd, kpq, kps, vpq, vps, pt, kl, num_buffers=depth)

    calls.update({
        "K9d2": k9(2),
        "K9d4": k9(4),
        "K7": lambda: da.decode_attention_quantized(qd, kdq, kds, vdq, vds,
                                                    kl),
        "K8": lambda: da.paged_decode_attention_quantized(
            qd, kpq, kps, vpq, vps, pt, kl),
        "K15": lambda: mg.grouped_matmul_quantized(xg, wq, ws),
    })
    if dtype == torch.float32:   # the f32 forward has no ring (no K4)
        return {f"{name} f32": fn for name, fn in calls.items()
                if not name.startswith("K4")}
    calls.update({
        "K14d": lambda: mg.grouped_matmul(xd, wd),
        "K14p": lambda: mg.grouped_matmul(xp, wp),
    })
    return calls


def _tensors(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def dump(path: str) -> None:
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn in _calls(dtype).items():
            out = _tensors(fn())
            torch.cuda.synchronize()
            result[name] = {"out": [t.cpu() for t in out], "ms": _ms(fn)}
    for ring, classic in RINGS.items():
        for suffix in ("", " f32"):
            if ring + suffix in result:
                result[ring + suffix]["equals_classic"] = all(
                    torch.equal(a, b) for a, b in zip(
                        result[ring + suffix]["out"],
                        result[classic + suffix]["out"]))
    result["device"] = torch.cuda.get_device_name(0)
    torch.save(result, path)


def _within(name: str, got, ref) -> bool:
    if name in ("K12", "K13", "K13e"):
        return all((g.float() - r.float()).abs().max().item()
                   <= tol * r.float().abs().max().item()
                   for g, r, tol in zip(got, ref, SSD_REL_TOL))
    if name in ("K11", "K14", "K14d", "K15"):
        tol = BWD_REL_TOL if name == "K11" else GMM_REL_TOL
        return all((g.float() - r.float()).abs().max().item()
                   <= tol * r.float().abs().max().item()
                   for g, r in zip(got, ref))
    return all((g.float() - r.float()).abs().max().item() <= tol
               for g, r, tol in zip(got, ref, FWD_TOL))


def compare(paths) -> int:
    dumps = [torch.load(p) for p in paths]
    print("device:", dumps[0]["device"])
    bad = []
    for name in dumps[0]:
        if name == "device":
            continue
        ref = dumps[0][name]["out"]
        equal = all(torch.equal(a, b) for d in dumps[1:]
                    for a, b in zip(d[name]["out"], ref))
        diff = max(((a.float() - b.float()).abs().max().item()
                    for d in dumps[1:] for a, b in zip(d[name]["out"], ref)),
                   default=0.0)
        times = " ".join(f"{d[name]['ms']:.4f}" for d in dumps)
        line = f"{name}: bit_equal={equal} max_abs_diff={diff:.3g} ms={times}"
        if name in TOLERANT:
            ok = all(_within(name, d[name]["out"], ref) for d in dumps[1:])
            line += f" within_tolerance={ok}"
        else:
            ok = equal
        if "equals_classic" in dumps[0][name]:
            ok = ok and all(d[name]["equals_classic"] for d in dumps)
            line += " equals_classic=" + "/".join(
                str(d[name]["equals_classic"]) for d in dumps)
        print(line)
        if not ok:
            bad.append(name)
    print("expected:", "all held" if not bad else f"FAILED {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) >= 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2:]))
    else:
        sys.exit(__doc__)
