"""Recompute the derived roofline fields of every dry-run record of the
port from its counts (when the model-FLOPs convention or a rate changes):
the counts themselves are kept as they are.

    PYTHONPATH=src python -m repro_torch.launch.rederive

Port of ``repro.launch.rederive``.  The compute term takes each dtype's
FLOPs over its rate (the record's ``flops_by_dtype``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import Roofline, model_flops_for


def main(root: Optional[Path] = None) -> int:
    n = 0
    for f in sorted((root or dryrun.RESULTS).glob("*.json")):
        r = json.loads(f.read_text())
        if not r.get("ok"):
            continue
        rl = r["roofline"]
        cfg = get_config(r["arch"])
        if r.get("reduced"):
            cfg = cfg.reduced()
        # re-apply any knob that changes flops accounting? (none do)
        shape = SHAPES[r["shape"]]
        new = Roofline(
            flops=rl["flops_per_device"],
            hbm_bytes=rl["hbm_bytes_per_device"],
            collective_bytes=rl["collective_bytes_per_device"],
            chips=r["chips"],
            model_flops=model_flops_for(cfg, shape),
            hbm_bytes_pessimistic=rl.get("hbm_bytes_pessimistic", 0.0),
            flops_by_dtype=r.get("flops_by_dtype"))
        r["roofline"] = new.to_dict()
        f.write_text(json.dumps(r, indent=1, default=float))
        n += 1
    print(f"rederived {n} records")
    return n


if __name__ == "__main__":
    main()
