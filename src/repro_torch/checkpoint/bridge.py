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


# Keys under which the reference's init keeps a leaf in f32 whatever the
# model dtype: the SSM's A_log, D and dt_bias (``models/ssm.py``) and the
# MoE router (``models/moe.py``).  A cast to the model dtype skips them.
F32_KEYS = frozenset({"A_log", "D", "dt_bias", "router"})


def _cast(t: torch.Tensor, path: tuple, device, dtype: Optional[str]):
    keep = dtype is None or any(k in F32_KEYS for k in path)
    return t.to(device=device, dtype=None if keep else torch_dtype(dtype))


def params_from_numpy(tree: Any, *, device="cuda",
                      dtype: Optional[str] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``; ``dtype`` (e.g. "bfloat16") casts every leaf that the
    reference's init makes in the model dtype (not those under
    :data:`F32_KEYS`)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        # a writable copy
        return _cast(torch.from_numpy(np.array(node)), path, device, dtype)

    return walk(tree, ())


def load_reference_checkpoint(directory: str | os.PathLike, *,
                              device="cuda",
                              dtype: Optional[str] = None) -> Any:
    """Read a reference checkpoint — a step directory, or a checkpoint
    root whose latest committed step is taken — into port parameters;
    ``dtype`` casts as :func:`params_from_numpy` does."""
    path = Path(directory)
    step = path if (path / "MANIFEST.json").exists() else step_dir(path)
    return unflatten({key: _cast(t, tuple(key.split("/")), device, dtype)
                      for key, t in read_step(step).items()})
