"""The persistent tuning database: measured winners keyed by
``(kernel, backend, shape-bucket)``.

Port of ``repro.core.autotune_search.db``.  One JSON artifact
(``results/tuning_db_torch.json``) shared by every process on the host,
wrapped in the versioned envelope of
:mod:`repro_torch.core.runtime.artifacts`, under a kind of its own: the
JAX package's db (``tuning_db``) and the port's never load each other's
entries.  Entries record the winning config
*and* its provenance — the measured median, the analytic pick it beat, and
how many candidates were timed — so a reader can audit whether the stored
winner still makes sense.  A warm db turns every steady-state
``lookup_or_search`` into a dict lookup: zero timed measurements.
"""

from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path
from typing import Optional

from repro_torch.core.runtime.artifacts import load_artifact, save_artifact

__all__ = ["TUNING_DB_KIND", "TUNING_DB_VERSION", "TuningDB"]

TUNING_DB_KIND = "tuning_db_torch"
# v1: buckets carry ``dv`` (every kernel) and ``rows`` (the decode
# kernels); configs carry ``num_buffers``, ``num_splits`` and the open
# paged bucket's ``page_size``.  A later schema bumps the version, and the
# envelope then loads an older db as empty.
TUNING_DB_VERSION = 1


@contextlib.contextmanager
def _file_lock(path: Path):
    """Exclusive advisory lock serializing load-merge-save across tuner
    processes (sidecar ``<db>.lock``; no-op where fcntl is unavailable —
    the merge then only guarantees same-process consistency)."""
    try:
        import fcntl
    except ImportError:  # non-posix: best-effort, no cross-process lock
        yield
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class TuningDB:
    """In-memory view of the tuning database, write-through to ``path``.

    ``path=None`` keeps the db memory-only (benchmarks and tests that must
    not pollute ``results/``)."""

    def __init__(self, path: Optional[os.PathLike | str] = None,
                 entries: Optional[dict] = None) -> None:
        self.path = Path(path) if path is not None else None
        self.entries: dict[str, dict] = dict(entries or {})
        self._recorded: dict[str, dict] = {}  # keys THIS process measured
        self._lock = threading.Lock()
        self.generation = 0   # bumped by every record

    @classmethod
    def open(cls, path: os.PathLike | str) -> "TuningDB":
        """Load the artifact at ``path`` (empty db on missing/mismatch)."""
        payload = load_artifact(path, kind=TUNING_DB_KIND,
                                version=TUNING_DB_VERSION)
        entries = payload.get("entries") if isinstance(payload, dict) else None
        return cls(path, entries if isinstance(entries, dict) else {})

    @staticmethod
    def key(kernel: str, backend: str, bucket: str) -> str:
        return f"{kernel}|{backend}|{bucket}"

    def lookup(self, kernel: str, backend: str,
               bucket: str) -> Optional[dict]:
        """The stored winning config, or None on a cache miss."""
        entry = self.entries.get(self.key(kernel, backend, bucket))
        if entry is None:
            return None
        cfg = entry.get("config")
        return dict(cfg) if isinstance(cfg, dict) else None

    def record(self, kernel: str, backend: str, bucket: str, config: dict,
               **provenance) -> None:
        """Store a winner and write the db through to disk (if persistent).

        The write merges the *current* on-disk entries with only the
        buckets THIS process measured: two tuner processes sharing one db
        file each searched different buckets, and a plain snapshot write
        would make the last writer silently drop the other's winners —
        while merging the whole open-time snapshot would resurrect stale
        values for buckets another process re-tuned since.  An exclusive
        file lock serializes the load-merge-save against other tuner
        processes.  (A bucket both processes measured still resolves
        last-writer-wins; both entries are valid measurements.)"""
        key = self.key(kernel, backend, bucket)
        entry = {"config": dict(config), **provenance}
        with self._lock:
            self.generation += 1
            self.entries[key] = entry
            self._recorded[key] = entry
            if self.path is None:
                return
            with _file_lock(self.path):
                payload = load_artifact(self.path, kind=TUNING_DB_KIND,
                                        version=TUNING_DB_VERSION)
                disk = (payload.get("entries")
                        if isinstance(payload, dict) else None)
                merged = {**disk, **self._recorded} \
                    if isinstance(disk, dict) else dict(self._recorded)
                self.entries = merged
                save_artifact(self.path, kind=TUNING_DB_KIND,
                              version=TUNING_DB_VERSION,
                              payload={"entries": merged})

    def __len__(self) -> int:
        return len(self.entries)
