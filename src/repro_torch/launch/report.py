"""Render the dry run's tables from the port's records
(results/dryrun_torch/).

    PYTHONPATH=src python -m repro_torch.launch.report roofline
    PYTHONPATH=src python -m repro_torch.launch.report perf

Port of ``repro.launch.report`` over the port's records: the times are
counts over the H100's rates (``launch/roofline.py``), and "count (s)"
(the seconds the count took) stands where the reference prints its
compile seconds.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Optional

from repro_torch.launch import dryrun


def load(tagged=False, root: Optional[Path] = None):
    rows = []
    for f in sorted((root or dryrun.RESULTS).glob("*.json")):
        r = json.loads(f.read_text())
        has_tag = bool(r.get("tag"))
        if has_tag != tagged:
            continue
        rows.append(r)
    return rows


def _arch(r) -> str:
    return r["arch"] + (" (reduced)" if r.get("reduced") else "")


def roofline_md(root: Optional[Path] = None):
    print("| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) |"
          " bottleneck | useful | frac | GB/dev | count (s) |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in load(root=root):
        if not r.get("ok"):
            print(f"| {_arch(r)} | {r['shape']} | {r['mesh']} |"
                  f" FAILED: {r.get('error','')[:60]} |")
            continue
        rl = r["roofline"]
        print(f"| {_arch(r)} | {r['shape']} | {r['mesh']} "
              f"| {rl['t_compute_s']:.3f} | {rl['t_memory_s']:.3f} "
              f"| {rl['t_collective_s']:.3f} | {rl['bottleneck']} "
              f"| {rl['useful_flops_ratio']:.2f} "
              f"| {rl['roofline_fraction']:.3f} "
              f"| {r['static_bytes_per_device']/1e9:.1f} "
              f"| {r['t_count_s']:.0f} |")


def perf_md(root: Optional[Path] = None):
    print("| cell | variant | t_comp | t_mem | t_coll | bottleneck |"
          " frac | Δfrac vs base |")
    print("|---|---|---|---|---|---|---|---|")
    base = {}
    for r in load(tagged=False, root=root):
        if r.get("ok"):
            base[(_arch(r), r["shape"], r["mesh"])] = (
                r["roofline"]["roofline_fraction"])
    entries = []
    for r in load(tagged=True, root=root):
        key = (_arch(r), r["shape"], r["mesh"])
        if not r.get("ok"):
            entries.append((key, r["tag"], None, r.get("error", "")[:60]))
            continue
        rl = r["roofline"]
        entries.append((key, r["tag"], rl, None))
    for key, tag, rl, err in sorted(entries, key=lambda x: (x[0], x[1])):
        cell = f"{key[0]}×{key[1]}×{key[2]}"
        if rl is None:
            print(f"| {cell} | {tag} | FAILED {err} |")
            continue
        b = base.get(key, 0)
        print(f"| {cell} | {tag} | {rl['t_compute_s']:.3f} "
              f"| {rl['t_memory_s']:.3f} | {rl['t_collective_s']:.3f} "
              f"| {rl['bottleneck']} | {rl['roofline_fraction']:.3f} "
              f"| {rl['roofline_fraction'] - b:+.3f} |")


if __name__ == "__main__":
    {"roofline": roofline_md, "perf": perf_md}[sys.argv[1]]()
