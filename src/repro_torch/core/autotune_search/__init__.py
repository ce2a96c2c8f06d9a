"""Measured autotuner for the kernels' template knobs on the card.

Port of ``repro.core.autotune_search`` for the five kernel ops it
searches: ``flash_attention`` (K1 / K4: tile and ring depth),
``decode_attention`` (K2 / K5, K7), ``paged_decode_attention`` (K3 / K6,
K8 / K9), ``moe_gmm`` (K14 / K15: the tile) and ``mamba_ssd`` (K12 /
K13: the chunk).  The
paper's discipline applied to the device knobs: the analytic cost model
``Cost(T,N,L)`` is a *prior* — it prunes the candidate space — and the
clock on the live card disposes.

Every kernel op resolves its config through one entry point::

    config = autotune_search.lookup_or_search("decode_attention",
                                              device=q.device, s=s, ...)

which consults the persistent tuning database
(``results/tuning_db_torch.json``, keyed by ``(kernel, card, shape
bucket)``) and falls back to the analytic pick on a cache miss —
steady-state lookups perform **zero** timed measurements (assert via
:func:`measurement_count`).  The analytic pick is what the kernels ran
before the search existed (depth 1, the classic split count, the
compiled tiles and chunk), so a miss changes nothing.  The measured search itself runs when explicitly
requested: the ``repro_torch.launch.tune`` CLI, or inline on a miss under
``REPRO_TUNING=search``.

``REPRO_TUNING`` modes (the variable the JAX package reads, so one
setting pins both):

* unset / ``on`` — db lookup; analytic fallback on miss (no measuring).
* ``search``     — measure on miss, persist the winner.
* ``off``        — analytic only; the db is never consulted (the hermetic
  setting pinned by ``tests/conftest.py``).

``REPRO_TORCH_TUNING_DB`` overrides the database path.  The port does not
read ``REPRO_TUNING_DB``: the JAX db would load here as a foreign kind
(empty), and a write would then replace it with the port's.
"""

from __future__ import annotations

import functools
import os
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.autotune_search.db import (TUNING_DB_KIND,
                                                 TUNING_DB_VERSION, TuningDB)
from repro_torch.core.autotune_search.kernels import (
    BUFFER_DEPTHS, PAGE_SIZE_OPTIONS, QUICK_SHAPES, REPRESENTATIVE_SHAPES,
    SPECS, KernelSpec, backend_name, dtype_name, fmt_items)
from repro_torch.core.autotune_search.search import (SearchOptions,
                                                     SearchResult, Trial,
                                                     measurement_count,
                                                     run_search)

__all__ = [
    "BUFFER_DEPTHS",
    "KernelSpec",
    "PAGE_SIZE_OPTIONS",
    "QUICK_SHAPES",
    "REPRESENTATIVE_SHAPES",
    "SPECS",
    "SearchOptions",
    "SearchResult",
    "Trial",
    "TUNING_DB_KIND",
    "TUNING_DB_VERSION",
    "TuningDB",
    "analytic_config",
    "backend_name",
    "dtype_name",
    "fmt_items",
    "get_db",
    "lookup_or_search",
    "measurement_count",
    "mode",
    "reset_db",
    "search_kernel",
    "set_db",
    "state",
    "tuning_db_path",
]

_LOCK = threading.Lock()
_DB: Optional[TuningDB] = None
_EPOCH = 0   # bumped whenever the process db view is replaced


def mode() -> str:
    """The active ``REPRO_TUNING`` mode: ``on`` | ``search`` | ``off``."""
    env = os.environ.get("REPRO_TUNING", "on").lower()
    if env in ("off", "0", "none", "false"):
        return "off"
    if env in ("search", "force", "tune"):
        return "search"
    return "on"


def tuning_db_path() -> Path:
    env = os.environ.get("REPRO_TORCH_TUNING_DB", "")
    if env:
        return Path(env)
    # src/repro_torch/core/autotune_search/__init__.py -> the repo root
    return (Path(__file__).resolve().parents[4] / "results"
            / "tuning_db_torch.json")


def get_db() -> TuningDB:
    """The process-wide db view (loaded from :func:`tuning_db_path` once)."""
    global _DB
    with _LOCK:
        if _DB is None:
            _DB = TuningDB.open(tuning_db_path())
        return _DB


def set_db(db: Optional[TuningDB]) -> None:
    """Install (or with None: clear) the process db view."""
    global _DB, _EPOCH
    with _LOCK:
        _DB = db
        _EPOCH += 1


def state() -> tuple:
    """What a resolution depends on besides the call's shape: the mode
    and, unless it is off, the process db view and its generation.  The
    ops memoize their routes under it, so a new db, a recorded winner or
    another mode resolves afresh."""
    m = mode()
    if m == "off":
        return (m,)
    db = get_db()
    return (m, _EPOCH, db.generation)


def reset_db() -> None:
    """Forget the cached view; the next :func:`get_db` re-reads disk."""
    set_db(None)


@functools.lru_cache(maxsize=4096)
def _analytic_cached(kernel: str, shape_items: tuple) -> tuple:
    cfg = SPECS[kernel].analytic_config(**dict(shape_items))
    return tuple(sorted(cfg.items()))


def analytic_config(kernel: str, **shape) -> dict:
    """The cost model's classic pick for this exact shape — never
    measures.  Memoized (the lookup runs on every kernel call; the pick
    is a pure function of kernel, shape and the card's SM count); a fresh
    dict per call keeps the cache unmutable by callers."""
    return dict(_analytic_cached(kernel, tuple(sorted(shape.items()))))


def _device(device) -> torch.device:
    # entry points run on the card unless the caller asks for the CPU
    return torch.device("cuda" if device is None else device)


def search_kernel(
    kernel: str,
    *,
    db: Optional[TuningDB] = None,
    options: Optional[SearchOptions] = None,
    device=None,
    **shape,
) -> SearchResult:
    """Run the measured search for one kernel / shape on ``device`` (the
    card by default) and record the winner in ``db`` (the process db by
    default).  Used by the ``repro_torch.launch.tune`` CLI;
    ``lookup_or_search`` calls it on a miss under ``REPRO_TUNING=search``."""
    spec = SPECS[kernel]
    dev = _device(device)
    bucket = spec.bucket(**shape)
    key = spec.bucket_key(bucket)
    backend = backend_name(dev)
    result = run_search(
        kernel=kernel, backend=backend, bucket=key,
        candidates=spec.candidates(bucket),
        make_runner=spec.runner_factory(bucket, dev), options=options)
    target = db if db is not None else get_db()
    target.record(
        kernel, backend, key, result.config,
        measured_s=result.measured_s,
        analytic_config=result.analytic_config,
        analytic_s=result.analytic_s,
        n_timed=result.n_timed)
    return result


def lookup_or_search(
    kernel: str,
    *,
    db: Optional[TuningDB] = None,
    options: Optional[SearchOptions] = None,
    device=None,
    **shape,
) -> dict:
    """Resolve a kernel config: tuned when the db knows this (card,
    bucket), analytic otherwise.  The one entry point every ``ops.py``
    uses."""
    spec = SPECS[kernel]
    m = mode()
    if m == "off":
        return analytic_config(kernel, **shape)
    dev = _device(device)
    bucket = spec.bucket(**shape)
    key = spec.bucket_key(bucket)
    target = db if db is not None else get_db()
    hit = target.lookup(kernel, backend_name(dev), key)
    if hit is not None:
        return hit
    if m == "search":
        return dict(search_kernel(kernel, db=target, options=options,
                                  device=dev, **shape).config)
    return analytic_config(kernel, **shape)
