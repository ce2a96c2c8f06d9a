"""Serve cache backends: the contiguous backend behind the engine's seam.

The engine's refill loop calls ``admit`` / ``finish`` and never touches
cache layout.  Only the contiguous backend is ported: one ``max_len``
cache row per slot, refill = pad-masked prefill + row splice.  The paged
pool, its page allocator and the prefix cache are not ported yet
(ROADMAP: paged serve with K3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class AdmitResult:
    """What the engine needs back from one successful admission."""

    logits_row: Any               # [V] first-token logits for the slot
    prefill_tokens: int           # prompt tokens actually computed
    prefix_hit_tokens: int        # prompt tokens served from shared pages


class ContiguousBackend:
    """One max_len cache row per slot, refill = pad-masked prefill + row
    splice (in place, into the serve cache)."""

    name = "contiguous"

    def __init__(self, engine):
        self.eng = engine
        engine._ensure_splice()
        self.begin_call()

    def begin_call(self) -> None:
        """Fresh rows every ``serve()`` call: contiguous rows carry no
        cross-call state worth keeping, and a stale row length would
        poison the first admission."""
        cfg = self.eng.cfg
        model = self.eng.model
        self.cache = model.set_cache_lengths(
            model.init_cache(cfg.slots, cfg.max_len, self.eng.kv_dtype),
            np.zeros(cfg.slots, np.int32))

    def validate(self, requests, cap_of) -> None:
        pass

    def admit(self, slot: int, req, cap: int) -> Optional[AdmitResult]:
        eng = self.eng
        logits, pcache = _prefill_request(eng, req)
        self.cache = eng._splice(self.cache, pcache, slot)
        return AdmitResult(logits[0], req.prompt_len, 0)

    def finish(self, slot: int) -> None:
        pass

    def fill_report(self, report) -> None:
        report.cache = self.name


def _prefill_request(eng, req):
    """One request through the engine's bucketed pad-masked prefill."""
    width = eng._bucket_width(req.prompt_len)
    toks = np.zeros((1, width), np.int32)
    toks[0, : req.prompt_len] = req.prompt
    return eng._prefill_padded(eng.params, toks,
                               np.asarray([req.prompt_len], np.int32))


def make_cache_backend(engine):
    """Build the backend named by ``ServeConfig.cache``."""
    kind = engine.cfg.cache
    if kind == "contiguous":
        return ContiguousBackend(engine)
    if kind == "paged":
        raise NotImplementedError(
            "ServeConfig(cache='paged'): not ported yet (ROADMAP: paged "
            "serve with K3)")
    raise ValueError(f"unknown ServeConfig.cache {kind!r} "
                     f"(expected 'contiguous' or 'paged')")
