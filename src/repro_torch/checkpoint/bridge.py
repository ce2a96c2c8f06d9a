"""Parameters across frameworks: the JAX package's trees into the port.

The port keeps the reference's parameter layout leaf for leaf (nested
dicts, layer-stacked leaves with a leading [n_layers] axis, dense weights
[d_in, d_out] applied as ``x @ w``), so the bridge converts and moves each
leaf and transposes nothing.

The reference's on-disk checkpoint is one directory per step holding
``MANIFEST.json`` ({step, keys: {"a/b/c": {shape, dtype, file}}}), one
``.npy`` per leaf and a ``COMMIT`` marker written last; a directory
without ``COMMIT`` is a torn save and is skipped.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype


def params_from_numpy(tree: Any, *, device="cuda",
                      dtype: Optional[str] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``; ``dtype`` (e.g. "bfloat16") casts every leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))   # a writable copy
    return t.to(device=device, dtype=torch_dtype(dtype) if dtype else None)


def _step_dir(directory: Path) -> Path:
    if (directory / "MANIFEST.json").exists():
        return directory
    steps = sorted(p for p in directory.glob("step_*")
                   if (p / "COMMIT").exists())
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    return steps[-1]


def load_reference_checkpoint(directory: str | os.PathLike, *,
                              device="cuda",
                              dtype: Optional[str] = None) -> Any:
    """Read a reference checkpoint — a step directory, or a checkpoint
    root whose latest committed step is taken — into port parameters."""
    step = _step_dir(Path(directory))
    manifest = json.loads((step / "MANIFEST.json").read_text())
    tree: dict = {}
    for key, meta in manifest["keys"].items():
        arr = np.load(step / meta["file"], allow_pickle=False)
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(f"{key}: file shape {arr.shape} != manifest "
                             f"{meta['shape']}")
        node = tree
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = arr
    return params_from_numpy(tree, device=device, dtype=dtype)
