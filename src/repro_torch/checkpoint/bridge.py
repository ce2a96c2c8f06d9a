"""Parameters across frameworks: the JAX package's trees into the port.

The port keeps the reference's parameter layout leaf for leaf (nested
dicts, layer-stacked leaves with a leading [n_layers] axis, dense weights
[d_in, d_out] applied as ``x @ w``), so the bridge converts and moves each
leaf and transposes nothing.

A reference checkpoint on disk is read through ``checkpoint.read_step``,
the one reader of the format (``checkpoint.py`` describes it): each leaf
by its manifest dtype, so the bfloat16 and fp8 leaves that numpy stores
as void arrays come back as their torch dtypes.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import read_step, step_dir, unflatten
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


def load_reference_checkpoint(directory: str | os.PathLike, *,
                              device="cuda",
                              dtype: Optional[str] = None) -> Any:
    """Read a reference checkpoint — a step directory, or a checkpoint
    root whose latest committed step is taken — into port parameters."""
    path = Path(directory)
    step = path if (path / "MANIFEST.json").exists() else step_dir(path)
    cast = torch_dtype(dtype) if dtype else None
    return unflatten({key: t.to(device=device, dtype=cast)
                      for key, t in read_step(step).items()})
