"""Multi-pod dry run: count every (arch x shape) cell's step at rank 0's
share of the production mesh, on meta tensors, and persist one JSON record
per cell.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Records land in results/dryrun_torch/<arch>__<shape>__<mesh>.json and are
skipped if already present (resumable).

Port of ``repro.launch.dryrun``, with its flags.  Where the reference lowers
and compiles each cell for 256 or 512 host devices, the port counts it
(``launch/roofline.py`` ``count_step``) on the meta device, inside a fake
process group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``) of world 256 or 512 at rank 0, over ``launch/mesh.py``'s
production mesh.  Nothing runs on any device: the fake group's
collectives return at once, and the count reads their shapes.

Each cell runs rank 0's share of the port's own step:

* train: rank 0's blocks of the parameters and of the AdamW state
  (``distributed/params.py`` ``param_shardings``, ``Layout``) through the
  port's sharded train step (``make_train_step(grad_shardings=...)``),
  which gathers the parameters whole and cuts the rank's rows of the
  batch itself;
* prefill and decode: rank 0's rows of the batch (split over the
  policy's batch axes, as the sharded step splits them) and their cache,
  through the port's serve path (``make_prefill_step`` /
  ``make_decode_step``), with the parameter blocks rank 0 holds gathered
  whole first, as the sharded train step gathers them (the serve path
  computes on whole parameters).  A decode's cache is the serve form
  (per-row lengths; a meta length counts every row at the cache's full
  length); under ``cache_layout="seq"`` it is rank 0's block of positions
  (``params.shard_cache``) under the ``decode_seq_shard`` policy.

``static_bytes_per_device`` is what rank 0 holds: its parameter blocks
and AdamW state (train), or its parameter blocks and its rows' cache
(prefill, decode).  A cell the port refuses is recorded as ``ok: False``
with the port's own message, as the reference records a failed cell.  A
cell whose MoE claim groups lie on several ranks runs the FAA ticket
(``models/moe.py``); on meta its row exchanges are counted at an even
split, which the record states (``moe_exchange``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import REGISTRY, SHAPES, applicable_shapes, get_config
from repro_torch.configs.inputs import input_specs
from repro_torch.core.tree import flatten
from repro_torch.distributed import params as psh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, ShardingPolicy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.roofline import (count_step, model_flops_for,
                                         roofline_of)
from repro_torch.models import Model, moe
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import (make_decode_step, make_prefill_step,
                                          make_train_step)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# what a record whose step ran the MoE's FAA ticket (``models/moe.py``)
# counted for its row exchanges: meta counts have no values
MOE_EXCHANGE_NOTE = ("meta: the FAA ticket's all-to-all rows counted at an "
                     "even split of every claim (each piece's tokens x top_k "
                     "over its group's owners, none dropped); its count "
                     "all-gathers are exact")


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block (one that is up already is kept; any other group raises)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"dry run: a {dist.get_backend()!r} group of "
                f"{dist.get_world_size()} ranks is up; the dry run needs a "
                f"fake group of {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree, layouts) -> float:
    """Static bytes rank 0 holds of a tree (params / opt state / cache)
    under its layouts: each leaf's block."""
    lays = flatten(layouts)
    return float(sum(math.prod(lays[k].block_shape) * leaf.element_size()
                     for k, leaf in flatten(tree).items()))


def _tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in flatten(tree).values()))


def _rows(batch: dict, mesh, axes: tuple) -> dict:
    """Rank 0's rows of every [B, ...] leaf, cut over the mesh ``axes`` as
    the sharded train step cuts them (``params._fit_spec``)."""
    coord = sharding.coordinate(mesh)
    out = {}
    for key, x in batch.items():
        spec = psh._fit_spec(P(axes, *[None] * (x.dim() - 1)),
                             tuple(x.shape), mesh)
        out[key] = psh.Layout(mesh, spec, tuple(x.shape)).block(x, coord)
    return out


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in sharding.axis_sizes(mesh).values())


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int = 1, grad_compression=None,
               overrides=None, seq_parallel: bool = False,
               layout: str = "tp", cache_layout: str = None, *,
               reduced: bool = False, mesh_shape: Optional[tuple] = None):
    """Returns (step, example_args, mesh, policy, cfg, shape, meta) for
    rank 0 of a fake group that is up (:func:`fake_world`).

    overrides: dataclasses.replace kwargs on the ModelConfig (hillclimb
    knobs: moe_dispatch_groups, remat_policy, capacity_factor, ...).
    seq_parallel: the sequence-parallel policy.  layout: "tp" (FSDP+TP)
    | "fsdp" (pure ZeRO-3).  cache_layout: the decode cache's layout,
    "seq" for the sequence-sharded decode (default: ``layout``).
    reduced: the config's reduced widths, and mesh_shape: a (data,
    model) mesh in place of the production one (a small world: tests)."""
    cfg = get_config(arch).with_dtype("bfloat16")
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if mesh_shape is not None:
        mesh = mesh_mod.make_mesh(mesh_shape, ("data", "model"),
                                  device="cpu")
    else:
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
    cache_layout = cache_layout or layout
    pol = ShardingPolicy(mesh, seq_parallel=seq_parallel,
                         fsdp_pure=(layout == "fsdp"),
                         decode_seq_shard=(cache_layout == "seq"))
    model = Model(cfg, device="meta")
    full = model.init(0)
    p_lays = psh.param_shardings(full, mesh, layout=layout)
    blocks = psh.shard_tree(full, p_lays)
    batch = input_specs(cfg, shape)
    static = _local_bytes(full, p_lays)
    enc_len = (shape.seq_len // cfg.encoder_downsample
               if cfg.family == "encdec" else None)

    if shape.kind == "train":
        opt_cfg = opt_mod.AdamWConfig()
        state_full = opt_mod.init_state(full, opt_cfg)
        o_lays = psh.tree_shardings(state_full, mesh,
                                    psh.RULESETS[layout])
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               grad_compression=grad_compression,
                               grad_shardings=p_lays)
        args = (blocks, psh.shard_tree(state_full, o_lays), batch)
        static += _local_bytes(state_full, o_lays)
    else:
        rows = _rows(batch, mesh, pol.batch_axes())
        b = rows["tokens"].shape[0]
        whole = lambda blk: psh.gather_tree(blk, p_lays)
        if shape.kind == "prefill":
            prefill = make_prefill_step(model, max_len=shape.seq_len)
            step = lambda blk, bt: prefill(whole(blk), bt)
            args = (blocks, rows)
            static += _tree_bytes(model.init_cache(
                b, shape.seq_len, torch.bfloat16, enc_len=enc_len))
        else:
            decode = make_decode_step(model)
            step = lambda blk, toks, c: decode(whole(blk), toks, c)
            if cache_layout == "seq":   # every global row, then its cut
                cache = model.init_cache(shape.global_batch, shape.seq_len,
                                         torch.bfloat16, enc_len=enc_len)
                cache = Model.set_cache_lengths(cache, torch.zeros(
                    shape.global_batch, dtype=torch.int32, device="meta"))
                cache, _ = psh.shard_cache(cache, mesh)
            else:
                cache = Model.set_cache_lengths(
                    model.init_cache(b, shape.seq_len, torch.bfloat16,
                                     enc_len=enc_len),
                    torch.zeros(b, dtype=torch.int32, device="meta"))
            args = (blocks, rows["tokens"], cache)
            static += _tree_bytes(cache)

    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
            "kind": shape.kind,
            "chips": math.prod(sharding.axis_sizes(mesh).values()),
            "static_bytes_per_device": static, "reduced": reduced}
    return step, args, mesh, pol, cfg, shape, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, microbatches: int = 1, grad_compression=None,
             overrides=None, seq_parallel: bool = False, layout: str = "tp",
             cache_layout: str = None, tag: str = "", verbose: bool = True,
             reduced: bool = False, mesh_shape: Optional[tuple] = None
             ) -> dict:
    """Count one cell (inside :func:`fake_world` of its mesh's size) and
    return its record."""
    t0 = time.time()
    step, args, mesh, pol, cfg, shape, meta = build_cell(
        arch, shape_name, multi_pod, microbatches, grad_compression,
        overrides=overrides, seq_parallel=seq_parallel, layout=layout,
        cache_layout=cache_layout, reduced=reduced, mesh_shape=mesh_shape)
    exchanges = moe.EXCHANGE_CALLS["all_to_all"]
    with sharding.policy(pol):
        stats = count_step(step, *args)
    t_count = time.time() - t0
    rl = roofline_of(stats, meta["chips"], model_flops_for(cfg, shape))
    record = {
        **meta,
        "ok": True,
        "tag": tag,
        "t_count_s": t_count,
        "memory_analysis": {
            "argument_size_in_bytes": stats.argument_bytes,
            "output_size_in_bytes": stats.output_bytes,
            "peak_live_bytes": stats.peak_live_bytes,
        },
        "roofline": rl.to_dict(),
        "flops_by_dtype": stats.flops_by_dtype,
        "kernels": stats.kernels,
        "collectives": {
            "bytes_by_kind": stats.coll_bytes_by_kind,
            "count_by_kind": stats.coll_count_by_kind,
            "raw_total": stats.collective_bytes,
            "top": stats.top_collectives,
        },
        "top_dots": stats.top_dots,
    }
    if moe.EXCHANGE_CALLS["all_to_all"] > exchanges:
        record["moe_exchange"] = MOE_EXCHANGE_NOTE
    if verbose:
        print(f"[{arch} x {shape_name} x {meta['mesh']}]"
              f" count={t_count:.1f}s"
              f" flops/dev={stats.flops:.3e} bytes/dev={stats.ideal_bytes:.3e}"
              f" coll/dev={stats.collective_bytes:.3e}"
              f" bottleneck={rl.bottleneck}"
              f" frac={rl.roofline_fraction:.3f}")
    return record


def failed_record(arch, shape_name, mesh: str, tag: str, err,
                  reduced: bool = False) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh, "ok": False,
            "tag": tag, "reduced": reduced,
            "error": f"{type(err).__name__}: {err}"[:500]}


def cell_path(arch, shape_name, mesh_name, tag="") -> Path:
    sfx = f"__{tag}" if tag else ""
    return RESULTS / f"{arch}__{shape_name}__{mesh_name}{sfx}.json"


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default=None)
    args = ap.parse_args(argv)

    RESULTS.mkdir(parents=True, exist_ok=True)
    cells = []
    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape else applicable_shapes(cfg))
        for sh in shapes:
            meshes = {"single": [False], "multi": [True],
                      "both": [False, True]}[args.mesh]
            for mp in meshes:
                cells.append((arch, sh, mp))

    done, failed = 0, 0
    for arch, sh, mp in cells:
        name = "2x16x16" if mp else "16x16"
        out = cell_path(arch, sh, name, args.tag)
        if out.exists() and not args.force:
            print(f"skip (cached): {out.name}")
            continue
        try:
            with fake_world(512 if mp else 256):
                rec = run_cell(arch, sh, mp, microbatches=args.microbatches,
                               grad_compression=args.grad_compression,
                               tag=args.tag)
            done += 1
        except Exception as e:
            traceback.print_exc()
            rec = failed_record(arch, sh, name, args.tag, e)
            failed += 1
        out.write_text(json.dumps(rec, indent=1, default=float))
    print(f"dry-run complete: {done} ok, {failed} failed")


if __name__ == "__main__":
    main()
