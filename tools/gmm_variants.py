"""Time the wgmma grouped product (K14 at C > 32, K17) against variants of
its own source, on the card.

Each variant is ``csrc/moe_gmm.cu`` (and ``common.cuh``) with a few
constants edited, built by ``nvcc`` into ``build/gmm_variants/<name>/``
beside the library the repository builds.  Every variant is first held to
the plain versions (within ``GMM_TOL``, a repeated call bit for bit), then
all of them, and the ``mma.sync`` kernels the rule ran before, are timed
in turns on the same inputs at the main path's shapes (CUDA events,
inputs cycled past the L2: ``chip_smoke.time_ms``).  The library is
called directly on the ``"wgmma"`` (or ``"mma"``) path; no launch is
counted.

    python3 tools/gmm_variants.py [--variants NAME ...] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as mg  # noqa: E402

# name: (what it tries, [(text in the source, its replacement)])
VARIANTS = {
    "stages_4": ("at most 4 ring stages",
                 [("constexpr int kWgMaxStages = 6;",
                   "constexpr int kWgMaxStages = 4;")]),
    "stages_8": ("at most 8 ring stages (8 at 64 rows, 6 at 128)",
                 [("constexpr int kWgMaxStages = 6;",
                   "constexpr int kWgMaxStages = 8;")]),
    "rows_128": ("128-row tiles above 128 rows too (C = 240 in two tiles: "
                 "each weight tile fetched twice)",
                 [("  return wgmma_launch<kAT, kBT, 256>(a, b, out, e, m, n, "
                   "k, stream);",
                   "  return wgmma_launch<kAT, kBT, 128>(a, b, out, e, m, n, "
                   "k, stream);")]),
}
K14_SHAPES = {"prefill": (64, 64, 2048, 1408), "train": (64, 240, 2048, 1408),
              "train_down": (64, 240, 1408, 2048)}
K17_SHAPES = {"train": (64, 240, 2048, 1408),
              "train_down": (64, 240, 1408, 2048)}
CHECK_K14 = [(4, 33, 64, 32), (2, 64, 128, 128), (2, 257, 128, 96),
             (1, 100, 72, 40), (64, 240, 2048, 1408)]
CHECK_K17 = [(4, 16, 64, 32), (1, 257, 136, 72), (3, 100, 72, 48),
             (64, 240, 2048, 1408)]


def build_variants(names) -> dict:
    """nvcc for each variant (all at once) and the repository's library;
    returns {name: library path}."""
    procs, paths = {}, {}
    for name in names:
        d = _build.BUILD / "gmm_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        files = {f: (_build.CSRC / f).read_text()
                 for f in ("moe_gmm.cu", "common.cuh")}
        for old, new in VARIANTS[name][1]:
            hits = [f for f in files if old in files[f]]
            if not hits:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            for f in hits:
                files[f] = files[f].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
        paths[name] = d / "libmoe_gmm.so"
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(paths[name]),
             str(d / "moe_gmm.cu")], stdout=open(d / "build.log", "w"),
            stderr=subprocess.STDOUT)
    _build.build(["moe_gmm"])
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"variant {name} did not build: "
                             f"{(paths[name].parent / 'build.log').read_text()}")
    paths["repo"] = _build.library_path("moe_gmm")
    return paths


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    for fn, argtypes in mg._ENTRY_POINTS.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def k14(lib, path):
    return cs.gmm_on_path(mg, path, lib)[0]


def k17(lib, path):
    return cs.gmm_on_path(mg, path, lib)[1]


def check(name, lib, gen) -> None:
    bf16 = torch.bfloat16
    for shape in CHECK_K14:
        x, w = cs.gmm_inputs(gen, *shape, bf16)
        out, again = k14(lib, "wgmma")(x, w), k14(lib, "wgmma")(x, w)
        err = cs.rel_err(out, mg.grouped_matmul_plain(x, w))
        cs.expect(err <= cs.GMM_TOL[bf16] and torch.equal(out, again),
                  f"{name} K14 {shape}: rel err {err}")
    for e, c, d, f in CHECK_K17:
        x, w = cs.gmm_inputs(gen, e, c, d, f, bf16)
        dy = cs.randn(gen, (e, c, f), bf16)
        got, again = k17(lib, "wgmma")(x, w, dy), k17(lib, "wgmma")(x, w, dy)
        want = mg.grouped_matmul_bwd_plain(x, w, dy)
        rel = [cs.rel_err(g, wt) for g, wt in zip(got, want)]
        cs.expect(max(rel) <= cs.GMM_TOL[bf16]
                  and all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} K17 {(e, c, d, f)}: rel errs {rel}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card()
    t0 = time.monotonic()
    libs = {n: load(p) for n, p in build_variants(args.variants).items()}
    print(f"card '{card}' build_s={time.monotonic() - t0:.1f}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, lib in libs.items():
        check(name, lib, gen)
    names = ["repo", *args.variants]
    result = {"card": card, "variants": {n: VARIANTS[n][0]
                                         for n in args.variants},
              "k14": {}, "k17": {}}
    bf16 = torch.bfloat16
    for case, shape in K14_SHAPES.items():
        sets = [cs.gmm_inputs(gen, *shape, bf16) for _ in range(3)]
        fns = [k14(libs[n], "wgmma") for n in names]
        fns.append(k14(libs["repo"], "mma"))
        ms = cs.in_turns(fns, sets, iters=15)
        result["k14"][case] = dict(zip(names + ["mma"], ms))
        result["k14"][case]["torch.bmm"] = cs.time_ms(torch.bmm, sets, 15)
        print(f"K14 {case} {shape}", {k: f"{v:.4f}" for k, v in
                                      result["k14"][case].items()},
              flush=True)
        del sets
    for case, (e, c, d, f) in K17_SHAPES.items():
        sets = []
        for _ in range(3):
            x, w = cs.gmm_inputs(gen, e, c, d, f, bf16)
            sets.append((x, w, cs.randn(gen, (e, c, f), bf16)))
        fns = [k17(libs[n], "wgmma") for n in names]
        fns.append(k17(libs["repo"], "mma"))
        ms = cs.in_turns(fns, sets, iters=10)
        result["k17"][case] = dict(zip(names + ["mma"], ms))
        for n in names:   # the dx / dw split of one call
            prof = cs.profile(lambda n=n: k17(libs[n], "wgmma")(*sets[0]), 2)
            result["k17"][case][f"{n}_dx_dw"] = (prof.get("k17_dx_ms"),
                                                 prof.get("k17_dw_ms"))
        print(f"K17 {case} {(e, c, d, f)}", {
            k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in result["k17"][case].items()}, flush=True)
        del sets
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
