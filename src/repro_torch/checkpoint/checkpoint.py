"""Checkpoints in the reference's on-disk format, both ways.

Port of ``repro.checkpoint.checkpoint``.  Layout (one directory per step):

    <dir>/step_000100/
        MANIFEST.json        {step, keys: {path: {shape, dtype, file}}}
        <flat-key>.npy       one array per leaf
        COMMIT               written last — a checkpoint without COMMIT is
                             torn (crashed mid-save) and ignored on restore

A save of the port is byte for byte the reference's save of the same
tree: keys are the "/"-joined dict paths in sorted order at every level
(``params/blocks/attn/wq/w``, ``opt/step``, ``opt/m/...``), as
``jax.tree_util`` flattens them, and each leaf is one ``.npy``.

numpy has no bfloat16 or float8 dtype of its own: the reference's numpy
(with ``ml_dtypes``) writes such a leaf with the header descr ``<V2`` /
``<V1`` and names its dtype in the manifest.  :func:`write_leaf` writes
those bytes without ``ml_dtypes``, and :func:`read_leaf` reads a leaf by
the manifest's dtype, viewing the void array's bytes as the torch dtype
(the reference's own restore cannot: its ``astype`` has no cast from
void).  ``restore`` puts each leaf on the device and dtype of the tree it
is given.

A sharded tree (each leaf this rank's block of a
``distributed.params.Layout``, ``shardings=``) is saved whole: every leaf
is gathered on the calling thread, rank 0 writes the reference's format
and the ranks meet at a barrier after it (``AsyncSaver`` gathers before
its thread starts and runs no collective in it).  ``restore(shardings=)``
reads each leaf by its manifest dtype and keeps this rank's block of it:
the elastic path, since the mesh a checkpoint was saved under does not
matter.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import flatten, unflatten
from repro_torch.distributed.params import gather_tree

# torch dtype -> the manifest's dtype name (numpy's, or ml_dtypes'): the
# dtypes of params, optimizer state and quantized leaves
DTYPE_NAMES = {
    torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
    torch.int8: "int8", torch.int32: "int32", torch.int64: "int64",
}
# dtypes numpy stores as void: (npy header descr, numpy word type of the
# same size, the torch dtype)
_VOID = {
    "bfloat16": ("<V2", "<u2", torch.bfloat16),
    "float8_e4m3fn": ("<V1", "u1", torch.float8_e4m3fn),
}


def write_leaf(path: Path, t: torch.Tensor) -> dict:
    """Write one leaf as the reference's ``np.save`` does; returns its
    manifest entry without the file name."""
    t = t.detach().cpu().contiguous()
    name = DTYPE_NAMES[t.dtype]
    if name in _VOID:
        descr, word, _ = _VOID[name]
        raw = t.view(torch.uint8 if word == "u1" else torch.uint16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": descr, "fortran_order": False,
                "shape": tuple(t.shape)})
            f.write(raw.tobytes())
    else:
        np.save(path, t.numpy(), allow_pickle=False)
    return {"shape": list(t.shape), "dtype": name}


def read_leaf(path: Path, dtype: str) -> torch.Tensor:
    """Read one leaf as a CPU tensor, dispatching on its manifest dtype:
    a bfloat16 leaf (``|V2`` when read without ``ml_dtypes``) is viewed as
    ``<u2`` and then as ``torch.bfloat16``, a float8_e4m3fn leaf (``|V1``)
    as ``u1`` and then as fp8; any other dtype is numpy's own."""
    arr = np.load(path, allow_pickle=False)
    if dtype in _VOID:
        _, word, tdtype = _VOID[dtype]
        return torch.from_numpy(np.array(arr.view(word))).view(tdtype)
    return torch.from_numpy(np.array(arr))   # a writable copy


def save(tree: Any, directory: str | os.PathLike, step: int, *,
         shardings: Any = None) -> Path:
    """Synchronous save; returns the checkpoint path.  Data goes into a
    temporary directory that is renamed at the end, then COMMIT is
    stamped: a preempted save never corrupts the latest checkpoint.  With
    ``shardings`` (collective) the leaves are blocks, gathered whole, and
    rank 0 writes."""
    if shardings is not None:
        tree = gather_tree(tree, shardings)
        path = step_dir(directory, step)
        if dist.get_rank() == 0:
            path = save(tree, directory, step)
        dist.barrier()
        return path
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "keys": {}}
    for key, leaf in flatten(tree).items():
        fname = key.replace("/", "__") + ".npy"
        manifest["keys"][key] = {**write_leaf(tmp / fname, leaf),
                                 "file": fname}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (final / "COMMIT").write_text("ok")
    return final


def _to_host(tree: Any) -> Any:
    return {k: _to_host(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in tree.items()}


class AsyncSaver:
    """Snapshot-then-write saver; at most one save in flight.  ``save``
    copies every leaf to host memory before it returns (the trainer
    updates its tensors in place), then writes on a thread.  With
    ``shardings`` it gathers the leaves first, on the calling thread;
    rank 0 writes, and ``wait`` meets the other ranks at a barrier once
    the write is done."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self.last_path: Optional[Path] = None

    def save(self, tree: Any, directory, step: int, *,
             shardings: Any = None) -> None:
        self.wait()
        self._sharded = shardings is not None
        if self._sharded:
            tree = gather_tree(tree, shardings)
            self.last_path = step_dir(directory, step)
            if dist.get_rank() != 0:
                return
        host_tree = _to_host(tree)

        def work():
            self.last_path = save(host_tree, directory, step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            dist.barrier()
            self._sharded = False


def _committed(base: Path) -> list[int]:
    if not base.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in base.iterdir()
                  if p.name.startswith("step_") and (p / "COMMIT").exists())


def latest_step(directory) -> Optional[int]:
    steps = _committed(Path(directory))
    return steps[-1] if steps else None


def step_dir(directory, step: Optional[int] = None) -> Path:
    """The directory of committed step ``step`` under the checkpoint root
    ``directory`` (the latest when ``step`` is None)."""
    base = Path(directory)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {base}")
    return base / f"step_{step:08d}"


def read_step(d: Path, keys=None) -> dict[str, torch.Tensor]:
    """The leaves of the step directory ``d`` as {flat key: CPU tensor}:
    those named in ``keys`` (every leaf when None), each read by its
    manifest dtype and held to the manifest's shape."""
    manifest = json.loads((d / "MANIFEST.json").read_text())["keys"]
    out = {}
    for key in manifest if keys is None else keys:
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = manifest[key]
        t = read_leaf(d / meta["file"], meta["dtype"])
        if list(t.shape) != list(meta["shape"]):
            raise ValueError(f"{key}: file shape {tuple(t.shape)} != "
                             f"manifest {meta['shape']}")
        out[key] = t
    return out


def restore(directory, step: Optional[int] = None, *, like: Any,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore a tree shaped as ``like`` (required): each leaf is read by
    its manifest dtype and cast to the device and dtype of ``like``'s
    leaf.  With ``shardings`` (a tree of ``Layout`` of the same keys) each
    leaf is held to its layout's full shape and this rank keeps its block
    of it, whatever mesh the checkpoint was saved under.  Returns (tree,
    step)."""
    d = step_dir(directory, step)
    want = flatten(like)
    lay = None if shardings is None else flatten(shardings)
    out = {}
    for path, arr in read_step(d, want).items():
        leaf = want[path]
        shape = tuple(leaf.shape) if lay is None else tuple(lay[path].shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {path}: ckpt "
                             f"{tuple(arr.shape)} vs {shape}")
        if lay is not None:
            arr = lay[path].shard(arr)
        out[path] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return unflatten(out), int(d.name.split("_")[1])


def prune_old(directory, keep: int = 3) -> None:
    base = Path(directory)
    for s in _committed(base)[:-keep]:
        shutil.rmtree(base / f"step_{s:08d}", ignore_errors=True)
