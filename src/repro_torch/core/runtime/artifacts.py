"""Versioned on-disk artifacts shared by the measurement layers.

Port of ``repro.core.runtime.artifacts``.  The port's measurement product
is the kernel tuning database (``results/tuning_db_torch.json``,
:mod:`repro_torch.core.autotune_search`; the host calibration is not
ported yet): a platform snapshot, a JSON file a *previous* process
measured on *some* card.  Loading one blindly is how a
stale or foreign snapshot silently mis-tunes a run, so every artifact is
wrapped in a ``{kind, version, payload}`` envelope and a reader only
accepts an exact (kind, version) match; anything else — missing file, torn
write, other artifact kind, older schema — loads as None and the caller
falls back to its analytic default.

Writes are atomic (tmp + rename): a reader never observes a half-written
artifact, which matters because the tuning db is appended to while other
processes may be mid-lookup.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

__all__ = ["load_artifact", "save_artifact"]


def save_artifact(path: os.PathLike | str, *, kind: str, version: int,
                  payload: Any) -> Path:
    """Atomically persist ``payload`` under a ``{kind, version}`` envelope.

    The tmp name is unique per process: two writers sharing one artifact
    path must not share a tmp file, or the loser's rename crashes on the
    winner's already-moved tmp."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(
        {"kind": kind, "version": version, "payload": payload}, indent=2))
    tmp.replace(p)
    return p


def load_artifact(path: os.PathLike | str, *, kind: str,
                  version: int) -> Optional[Any]:
    """Return the payload iff the file is a well-formed ``kind``/``version``
    artifact; None otherwise (missing, corrupt, or mismatched)."""
    p = Path(path)
    if not p.exists():
        return None
    try:
        raw = json.loads(p.read_text())
    except (ValueError, OSError):
        return None
    if not isinstance(raw, dict):
        return None
    if raw.get("kind") != kind or raw.get("version") != version:
        return None
    return raw.get("payload")
