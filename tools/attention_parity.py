#!/usr/bin/env python3
"""Outputs and times of the port's attention kernels at the serve and
training paths' square head-dim shapes, for holding one tree's kernels to
another's on the card.

    PYTHONPATH=<tree>/src python3 tools/attention_parity.py dump OUT.pt
    python3 tools/attention_parity.py compare A.pt B.pt [C.pt ...]

``dump`` imports ``repro_torch`` from the path given (so it builds and
runs that tree's kernels), feeds K1, K2, K3, K7, K8, K10 and K11 the
same inputs drawn from a CPU generator seeded with 0 (bf16; the shapes of
``chip_smoke.py``'s kernel rows), and saves each output with its device
ms per call (CUDA events around 30 calls on the same inputs, L2-warm,
after a warm-up).  ``compare``
prints, for each kernel, whether every dump's output equals the first
one's bit for bit, and the times side by side.  Run the dumps of two
trees in turns (A, B, B, A) in one call on one card.
"""

from __future__ import annotations

import sys

import torch


def _inputs():
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
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


def dump(path: str) -> None:
    from repro_torch.kernels import quant
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    x = _inputs()
    q, k, v = x["prefill"]
    qd, kd, vd, kl = x["decode"]
    kp, vp, pt = x["pool"]
    qt, kt, vt, dout = x["train"]

    def q8(t):
        return quant.quantize(t, dtype=torch.int8,
                              scale_dtype=quant.SCALE_DTYPE)

    (kq, ks), (vq, vs) = q8(k), q8(v)
    (kdq, kds), (vdq, vds) = q8(kd), q8(vd)
    (kpq, kps), (vpq, vps) = q8(kp), q8(vp)
    out_t, lse_t = fa.flash_attention(qt, kt, vt)
    calls = {
        "K1": lambda: fa.flash_attention(q, k, v, kv_len=512, q_offset=0)[0],
        "K2": lambda: da.decode_attention(qd, kd, vd, kl),
        "K3": lambda: da.paged_decode_attention(qd, kp, vp, pt, kl),
        "K10": lambda: fa.flash_attention_quantized(
            q, kq, ks, vq, vs, kv_len=512, q_offset=0)[0],
        "K7": lambda: da.decode_attention_quantized(qd, kdq, kds, vdq, vds,
                                                    kl),
        "K8": lambda: da.paged_decode_attention_quantized(
            qd, kpq, kps, vpq, vps, pt, kl),
        "K11": lambda: torch.cat([g.flatten() for g in fa.flash_attention_bwd(
            qt, kt, vt, out_t, lse_t, dout)]),
    }
    result = {}
    for name, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        result[name] = {"out": out.cpu(), "ms": _ms(fn)}
    result["device"] = torch.cuda.get_device_name(0)
    torch.save(result, path)


def compare(paths) -> None:
    dumps = [torch.load(p) for p in paths]
    print("device:", dumps[0]["device"])
    for name in dumps[0]:
        if name == "device":
            continue
        ref = dumps[0][name]["out"]
        equal = all(torch.equal(d[name]["out"], ref) for d in dumps[1:])
        diff = max((d[name]["out"].float() - ref.float()).abs().max().item()
                   for d in dumps[1:])
        times = " ".join(f"{d[name]['ms']:.4f}" for d in dumps)
        print(f"{name}: bit_equal={equal} max_abs_diff={diff:.3g} "
              f"ms={times}")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) >= 4 and sys.argv[1] == "compare":
        compare(sys.argv[2:])
    else:
        sys.exit(__doc__)
