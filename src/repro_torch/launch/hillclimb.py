"""Perf hillclimb: run tagged dry-run variants of one cell.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch qwen2.5-32b --shape prefill_32k --variant sp

Port of ``repro.launch.hillclimb``: the same variant names, each mapped
to the port's options (``launch/dryrun.py`` ``run_cell``).  Variants are
named knob bundles (hypothesis -> change); records land next to the
baselines as <arch>__<shape>__16x16__<tag>.json for the before/after
table (``launch/report.py perf``).  Where the port has no knob of its
own the variant counts as another:

* ``kvblk`` (the reference's reverted sharding constraint on the stacked
  KV blocks) counts as the base: the port constrains no layout;
* ``sp_bk8k`` and ``sp_bk16k`` (a larger flash KV chunk) count as ``sp``:
  the port reads no ``attn_block_k``, and K1's block_k has been pinned
  since F1 (``kernels/flash_attention/ops.py`` ``route``).

A variant the port refuses (``sp_moeshard``: the expert-parallel layer's
experts split over "model", which carries the sequence) is recorded as
``ok: False`` with the port's message.
"""

import argparse
import json
import traceback
from typing import Optional, Sequence

from repro_torch.launch import dryrun

VARIANTS = {
    # sequence-parallel activations (Korthikanti-style SP on the model axis)
    "sp": dict(seq_parallel=True),
    # remat keeps matmul outputs (less recompute, more activation memory)
    "dots": dict(overrides={"remat_policy": "dots"}),
    "sp_dots": dict(seq_parallel=True, overrides={"remat_policy": "dots"}),
    # bf16 gradient all-reduce compression
    "gc": dict(grad_compression="bf16"),
    "sp_gc": dict(seq_parallel=True, grad_compression="bf16"),
    "sp_dots_gc": dict(seq_parallel=True, grad_compression="bf16",
                       overrides={"remat_policy": "dots"}),
    # hierarchical (core-group) MoE dispatch: per-shard claim counters
    "moegrp16": dict(overrides={"moe_dispatch_groups": 16}),
    "moegrp256": dict(overrides={"moe_dispatch_groups": 256}),
    "sp_moegrp16": dict(seq_parallel=True,
                        overrides={"moe_dispatch_groups": 16}),
    "sp_moegrp256": dict(seq_parallel=True,
                         overrides={"moe_dispatch_groups": 256}),
    "sp_moegrp256_dots": dict(
        seq_parallel=True,
        overrides={"moe_dispatch_groups": 256, "remat_policy": "dots"}),
    # gradient-accumulation microbatching (collective/compute overlap)
    "mb2": dict(microbatches=2),
    "mb4": dict(microbatches=4),
    "sp_mb4": dict(seq_parallel=True, microbatches=4),
    # pure-FSDP (ZeRO-3) layout: no TP, no per-layer activation all-reduces
    "fsdp": dict(layout="fsdp"),
    "fsdp_dots": dict(layout="fsdp", overrides={"remat_policy": "dots"}),
    "fsdp_gc": dict(layout="fsdp", grad_compression="bf16"),
    # expert-parallel MoE: all_to_all dispatch with per-shard claiming
    "moeshard": dict(overrides={"moe_impl": "sharded"}),
    "moeshard_dots": dict(overrides={"moe_impl": "sharded",
                                     "remat_policy": "dots"}),
    "sp_moeshard": dict(seq_parallel=True,
                        overrides={"moe_impl": "sharded"}),
    # ZeRO-3 + Ulysses-style sequence sharding on the model axis
    "fsdp_sp": dict(layout="fsdp", seq_parallel=True),
    # ZeRO-3 + expert-parallel MoE (experts stay EP in the fsdp ruleset)
    "fsdp_moeshard": dict(layout="fsdp", overrides={"moe_impl": "sharded"}),
    "fsdp_moeshard_dots": dict(layout="fsdp",
                               overrides={"moe_impl": "sharded",
                                          "remat_policy": "dots"}),
    # kvblk: the reference's constraint on stacked KV blocks; the base here
    "kvblk": dict(),
    # kvseq: sequence-sharded KV cache + flash-decode with a
    # partial-softmax combine
    "kvseq": dict(cache_layout="seq"),
    # a larger flash chunk in the reference; sp here (module docstring)
    "sp_bk8k": dict(seq_parallel=True),
    "sp_bk16k": dict(seq_parallel=True),
}


def run_variant(arch: str, shape: str, variant: str, multi: bool = False,
                **kw) -> dict:
    """The record of one variant (``ok: False`` with the port's message
    where it refuses), inside a fake group of the mesh's size.  ``kw``
    passes on to ``dryrun.run_cell`` (``reduced``, ``mesh_shape``)."""
    shape_mesh = kw.get("mesh_shape")
    world = (shape_mesh[0] * shape_mesh[1] if shape_mesh
             else 512 if multi else 256)
    name = ("x".join(map(str, shape_mesh)) if shape_mesh
            else "2x16x16" if multi else "16x16")
    try:
        with dryrun.fake_world(world):
            return dryrun.run_cell(arch, shape, multi, tag=variant,
                                   **VARIANTS[variant], **kw)
    except Exception as e:
        traceback.print_exc()
        return dryrun.failed_record(arch, shape, name, variant, e,
                                    kw.get("reduced", False))


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    multi = args.mesh == "multi"
    mesh_name = "2x16x16" if multi else "16x16"
    out = dryrun.cell_path(args.arch, args.shape, mesh_name, args.variant)
    if out.exists() and not args.force:
        print(f"cached: {out.name}")
        return
    rec = run_variant(args.arch, args.shape, args.variant, multi)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=float))


if __name__ == "__main__":
    main()
