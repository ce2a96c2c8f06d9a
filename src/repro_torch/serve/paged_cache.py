"""Serve cache backends: contiguous rows, or a paged pool with a
registry-driven free list and prefix reuse.

The contiguous serve cache reserves ``max_len`` rows per slot, so memory —
not compute — caps concurrency.  The paged backend keeps KV memory as a
pool of fixed-size pages and each slot holds only a page table; a request
occupies exactly ``ceil((prompt + budget) / page_size)`` pages, so a fixed
byte budget admits more concurrent short requests than it has contiguous
slots' worth of rows.

The free list is the paper's experiment in miniature: page claims run as a
real ParallelFor (pages to claim = iteration space, decode slots = the
threads) under whichever scheduler the registry names, so
:class:`PageAllocator` inherits every policy's FAA behavior — one shared
claim counter (``faa``), per-group lanes (``hierarchical``), local queues
(``stealing``) — and its :class:`ScheduleStats` land in the serve report
alongside the admission telemetry.

:class:`PrefixCache` adds shared-prefix reuse on top of the refcounts:
prompt pages are keyed by a chained page-granular token key (a trie — no
hash collisions by construction), and a request whose prompt extends a
cached prefix maps the cached pages into its own page table (refcount +1,
zero prefill recompute for those tokens) and prefills only the suffix.
Eviction is LRU over *leaf* entries whose page the cache alone still
references — a page shared with any live request is never reclaimed.

The two backend classes give ``serve/engine.py`` one seam: the engine's
refill loop calls ``admit`` / ``finish`` and never touches cache layout.
``admit`` returning None (page pressure) is the partial-admission signal —
the engine pushes the request back onto the slot's backlog and retries
after decode ticks free pages.

Port of ``repro.serve.paged_cache``.  Both backends keep their caches on
the model's device and update them in place; on CUDA every paged decode
tick reads the pool through K3, or K6 where the tuning db says so
(``models/attention.py``).  ``ServeConfig(page_size=None)`` resolves the
page size as the reference does, through the tuning db's open
``paged_decode_attention`` bucket (``page_size=0``) for this cache
(``core/autotune_search``): the tuned page size where the db knows the
bucket, else the analytic 16.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import faults as _faults
from repro_torch.core import parallel_for as pf
from repro_torch.core.tree import leaves
from repro_torch.core.schedulers import ScheduleStats

# ---------------------------------------------------------------------------
# Page allocator
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list allocator over physical pages ``1..num_pages``.

    Page 0 is the reserved scratch page (idle decode slots write there) —
    it is never in the free list and never allocatable.  Claims run under
    ``schedule`` via :func:`parallel_for_stats` with ``slots`` threads, so
    ``stats`` holds the *policy's own* FAA decomposition per claim batch.

    Guards (the property suite's contracts): a page leaves the free list
    with refcount exactly 0 and returns only at refcount 0 (use-after-free
    / exactly-once), ``free`` below refcount 1 raises (double free), and
    ``share`` of a dead page raises.
    """

    def __init__(self, num_pages: int, *, slots: int = 1,
                 schedule="faa", block_size: Optional[int] = None):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        self.num_pages = num_pages
        self.slots = max(1, int(slots))
        self.schedule = schedule
        self.block_size = block_size
        # pop() hands out ascending page ids on a fresh pool
        self._free = list(range(num_pages, 0, -1))
        self.refcount = np.zeros(num_pages + 1, np.int64)
        self.stats: List[ScheduleStats] = []
        self.pages_allocated = 0
        self.pages_freed = 0
        self.peak_live = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return self.num_pages - len(self._free)

    def try_alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` pages, or None if the pool cannot cover them (the
        caller defers — partial admission).  The claim loop is the paper's
        ParallelFor: each iteration is one page grab, and the policy
        decides how many grabs ride on each shared-counter FAA."""
        if n < 0:
            raise ValueError(f"cannot claim {n} pages")
        if n == 0:
            return []
        # injected page pressure: a PageFailure spec makes this claim
        # report exhaustion even when pages are free — the deferral /
        # aging / shedding machinery upstream cannot tell the difference,
        # which is the point (one global read when no plan is installed)
        inj = _faults.active()
        if inj is not None and inj.page_alloc_should_fail(n):
            return None
        if n > len(self._free):
            return None
        got = np.zeros(n, np.int64)
        lock = threading.Lock()

        def claim(i: int) -> None:
            with lock:
                page = self._free.pop()
                if self.refcount[page] != 0:
                    raise RuntimeError(
                        f"free list handed out live page {page} "
                        f"(refcount {self.refcount[page]})")
                self.refcount[page] = 1
                got[i] = page

        stats = pf.parallel_for_stats(
            claim, n, n_threads=self.slots, schedule=self.schedule,
            block_size=self.block_size, layer="paged_alloc")
        self.stats.append(stats)
        self.pages_allocated += n
        self.peak_live = max(self.peak_live, self.live_count)
        return [int(p) for p in got]

    def alloc(self, n: int) -> List[int]:
        got = self.try_alloc(n)
        if got is None:
            raise RuntimeError(
                f"out of pages: need {n}, free {len(self._free)} "
                f"of {self.num_pages}")
        return got

    def share(self, pages) -> None:
        """Add one reference to each page (prefix fork / cache insert)."""
        for p in pages:
            p = int(p)
            self._check_range(p)
            if self.refcount[p] < 1:
                raise RuntimeError(
                    f"share of dead page {p} (use-after-free)")
            self.refcount[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; a page rejoins the free list only
        when its last reference dies — shared pages survive."""
        for p in pages:
            p = int(p)
            self._check_range(p)
            if self.refcount[p] < 1:
                raise RuntimeError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                self.pages_freed += 1

    def _check_range(self, p: int) -> None:
        if not 1 <= p <= self.num_pages:
            raise ValueError(
                f"page {p} out of range [1, {self.num_pages}] "
                f"(page 0 is the reserved scratch page)")


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("eid", "key", "page", "parent", "children", "stamp")

    def __init__(self, eid, key, page, parent):
        self.eid = eid
        self.key = key
        self.page = page
        self.parent = parent
        self.children = 0
        self.stamp = 0


class PrefixCache:
    """Token-prefix -> physical-page map at page granularity.

    Entries form a trie: an entry's key is ``(parent_id, page_tokens)``,
    so two prompts share exactly their common page-aligned prefix and
    lookups are collision-free.  The cache holds one allocator reference
    per entry; ``evict`` releases LRU leaves whose page nobody else
    references, never an interior node (children would dangle) and never a
    page a live request shares.
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self._by_key: Dict[tuple, _Entry] = {}
        self._clock = 0
        self._next_id = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_key)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _page_tokens(self, prompt, j: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])

    def match(self, prompt) -> List[int]:
        """Longest cached page-prefix of ``prompt``, as physical pages in
        logical order.  Capped at ``(len - 1) // page_size`` pages: at
        least one suffix token always stays uncached, because the first
        output token needs logits the pages cannot carry."""
        limit = (len(prompt) - 1) // self.page_size
        pages: List[int] = []
        parent = -1
        for j in range(limit):
            e = self._by_key.get((parent, self._page_tokens(prompt, j)))
            if e is None:
                break
            pages.append(e.page)
            e.stamp = self._tick()
            parent = e.eid
        return pages

    def insert(self, prompt, pages) -> None:
        """Record every page fully covered by ``prompt`` (``pages`` is the
        request's logical->physical map).  New entries take a reference on
        their page; pages already cached keep the original copy."""
        full = len(prompt) // self.page_size
        parent, parent_e = -1, None
        for j in range(full):
            key = (parent, self._page_tokens(prompt, j))
            e = self._by_key.get(key)
            if e is None:
                self.alloc.share([pages[j]])
                e = _Entry(self._next_id, key, int(pages[j]), parent_e)
                self._next_id += 1
                self._by_key[key] = e
                if parent_e is not None:
                    parent_e.children += 1
            e.stamp = self._tick()
            parent, parent_e = e.eid, e

    def evict(self, need: int) -> int:
        """Release up to ``need`` pages, LRU-first over evictable leaves
        (no children, refcount 1 — the cache is the sole owner).  Evicting
        a leaf can expose its parent, so the loop re-scans until satisfied
        or stuck; returns the number of pages actually freed."""
        freed = 0
        while freed < need:
            cands = [e for e in self._by_key.values()
                     if e.children == 0 and self.alloc.refcount[e.page] == 1]
            if not cands:
                break
            e = min(cands, key=lambda c: c.stamp)
            del self._by_key[e.key]
            if e.parent is not None:
                e.parent.children -= 1
            self.alloc.free([e.page])
            self.evictions += 1
            freed += 1
        return freed


# ---------------------------------------------------------------------------
# Serve backends
# ---------------------------------------------------------------------------


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


class PagedBackend:
    """Paged pool + page-table decode behind the same seam.

    Families: dense pages its full KV; hybrid pages the shared attention
    leaves and keeps the recurrent state per slot; ssm has nothing that
    grows, so it demands zero pages and degenerates to per-slot state
    under the same admission flow (the ``has_pages`` False branches).
    Prefix reuse is dense-only (``Model.prefix_shareable``): a hybrid
    prefix's recurrent state lives outside the pages.
    """

    name = "paged"

    def __init__(self, engine):
        self.eng = engine
        cfg = engine.cfg
        model = engine.model
        if not model.supports_paged_kv:
            raise ValueError(
                f"family {model.cfg.family!r}"
                f"{' (MLA)' if model.cfg.use_mla else ''} has no paged "
                f"decode path — use ServeConfig(cache='contiguous')")
        dtype = engine.kv_dtype
        ps = cfg.page_size
        if ps is None:
            # resolve the tuned page size from the autotuner db: the
            # page_size=0 sentinel bucket's candidates sweep page sizes
            # (and staging depths) for this cache shape and storage dtype
            from repro_torch.core import autotune, autotune_search
            hd = model.cfg.resolved_head_dim
            picked = autotune_search.lookup_or_search(
                "paged_decode_attention", device=model.device, s=cfg.max_len,
                page_size=0, d=hd, dv=hd,
                dtype=autotune_search.dtype_name(dtype),
                rows=cfg.slots * model.cfg.n_kv_heads)
            ps = autotune.fit_block(cfg.max_len,
                                    int(picked.get("page_size", 16)))
        if cfg.max_len % ps:
            raise ValueError(
                f"max_len {cfg.max_len} must be a multiple of page_size "
                f"{ps}")
        self.ps = ps
        self.pages_per_seq = cfg.max_len // ps
        self.spec = model.cache_page_spec(dtype=dtype)
        self.axes = model.cache_batch_axes(dtype=dtype)
        self.has_pages = any(ax >= 0 for ax in leaves(self.spec))
        self.num_pages = cfg.num_pages
        if self.num_pages is None:
            # slot parity: same KV bytes as the contiguous engine
            self.num_pages = cfg.slots * self.pages_per_seq
        self.alloc = PageAllocator(
            self.num_pages, slots=cfg.slots,
            schedule=cfg.page_alloc_schedule or cfg.refill_schedule,
            block_size=cfg.page_alloc_block)
        self.prefix: Optional[PrefixCache] = None
        if cfg.prefix_cache and model.prefix_shareable and self.has_pages:
            self.prefix = PrefixCache(self.alloc, self.ps)
        self.cache = model.init_paged_cache(
            cfg.slots, cfg.max_len, self.num_pages, self.ps, dtype)
        self.slot_pages: List[List[int]] = [[] for _ in range(cfg.slots)]
        self.deferred = 0
        self.begin_call()

    def begin_call(self) -> None:
        """Arm a per-call report window.  The pool, the prefix trie and
        their lifetime counters persist across ``serve()`` calls (a prefix
        cached in one call must hit in the next); each call's
        ``ServeReport`` covers that call alone, as deltas against this
        snapshot, and the peak-live watermark re-arms at the current
        residency."""
        self._snap = {
            "pages_allocated": self.alloc.pages_allocated,
            "pages_freed": self.alloc.pages_freed,
            "stats": len(self.alloc.stats),
            "deferred": self.deferred,
            "hits": 0 if self.prefix is None else self.prefix.hits,
            "hit_tokens": (0 if self.prefix is None
                           else self.prefix.hit_tokens),
        }
        self.alloc.peak_live = self.alloc.live_count

    # ------------------------------------------------------------- admission

    def demand(self, req, cap: int) -> int:
        """Pages the request occupies over its whole life (prompt + token
        budget, allocated up front so admission — not decode — is the only
        place the pool can run dry)."""
        if not self.has_pages:
            return 0
        return -(-(req.prompt_len + cap) // self.ps)

    def validate(self, requests, cap_of) -> None:
        for r in requests:
            d = self.demand(r, cap_of(r))
            if d > self.num_pages:
                raise ValueError(
                    f"request {r.rid}: needs {d} pages but the pool holds "
                    f"{self.num_pages} — raise num_pages or trim the "
                    f"request")

    def admit(self, slot: int, req, cap: int) -> Optional[AdmitResult]:
        eng = self.eng
        model = eng.model
        if not self.has_pages:          # ssm: constant-size per-slot state
            logits, pcache = _prefill_request(eng, req)
            self.cache = model.admit_paged_slot(
                self.cache, pcache, slot, req.prompt_len,
                np.zeros(self.pages_per_seq, np.int32), spec=self.spec,
                axes=self.axes)
            return AdmitResult(logits[0], req.prompt_len, 0)

        total = self.demand(req, cap)
        matched: List[int] = []
        if self.prefix is not None:
            matched = self.prefix.match(req.prompt)
        if matched:
            # pin before any eviction: a page named by this admission must
            # never be reclaimed to satisfy this same admission
            self.alloc.share(matched)
        need = total - len(matched)
        if need > self.alloc.free_count and self.prefix is not None:
            self.prefix.evict(need - self.alloc.free_count)
        got = self.alloc.try_alloc(need)
        if got is None:                 # page pressure: defer, retry later
            if matched:
                self.alloc.free(matched)
            self.deferred += 1
            return None

        pages = matched + got
        pt_row = np.zeros(self.pages_per_seq, np.int32)
        pt_row[: len(pages)] = pages
        mtok = len(matched) * self.ps
        prompt_pages = -(-req.prompt_len // self.ps)

        try:
            if matched:
                # zero prefill recompute for the cached prefix: a batch-of-1
                # contiguous view of the row's pages, extended by the
                # continuation prefill over the suffix only
                view = model.gather_prefix_cache(
                    self.cache, pt_row, mtok, spec=self.spec,
                    page_size=self.ps)
                logits, pcache = model.prefill_continue(
                    eng.params, np.asarray(req.prompt[mtok:])[None, :],
                    view)
            else:
                logits, pcache = _prefill_request(eng, req)
            self.cache = model.write_page(
                self.cache, pcache, pages[len(matched):prompt_pages],
                list(range(len(matched), prompt_pages)), spec=self.spec,
                page_size=self.ps)
            self.cache = model.admit_paged_slot(
                self.cache, pcache, slot, req.prompt_len, pt_row,
                spec=self.spec, axes=self.axes)
        except BaseException:
            # an admission that dies mid-way hands every page reference it
            # took straight back (matched pages drop to their prior
            # refcount, fresh pages rejoin the free list); the trie never
            # saw these pages (insert runs below)
            self.alloc.free(pages)
            raise
        if self.prefix is not None:
            if matched:
                self.prefix.hits += 1
                self.prefix.hit_tokens += mtok
            self.prefix.insert(req.prompt, pages)
        self.slot_pages[slot] = pages
        return AdmitResult(logits[0], req.prompt_len - mtok, mtok)

    def finish(self, slot: int) -> None:
        """Release the slot's page references and detach it from the pool:
        the page-table row goes back to the scratch page and the length to
        0, so this (now idle) slot's dead decode writes land in scratch
        page 0 instead of scribbling over reused pages."""
        if self.slot_pages[slot]:
            self.alloc.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
        if self.has_pages:
            self.cache = _release_slot(self.cache, slot)

    def fill_report(self, report) -> None:
        # per-call deltas against the begin_call() snapshot: the backend
        # outlives the call, the report must not (see begin_call)
        snap = self._snap
        report.cache = self.name
        report.num_pages = self.num_pages
        report.pages_allocated = (self.alloc.pages_allocated
                                  - snap["pages_allocated"])
        report.pages_freed = self.alloc.pages_freed - snap["pages_freed"]
        report.peak_pages_live = self.alloc.peak_live
        report.page_alloc_stats = list(self.alloc.stats[snap["stats"]:])
        report.deferred_admissions = self.deferred - snap["deferred"]
        if self.prefix is not None:
            report.prefix_hits = self.prefix.hits - snap["hits"]
            report.prefix_hit_tokens = (self.prefix.hit_tokens
                                        - snap["hit_tokens"])


def _release_slot(cache, slot: int):
    """Zero one slot's page-table row and length everywhere in the tree,
    in place; returns ``cache``."""
    for key, leaf in cache.items():
        if key == "pt":
            leaf.select(leaf.dim() - 2, slot).zero_()
        elif key == "len":
            leaf.select(leaf.dim() - 1, slot).zero_()
        elif isinstance(leaf, dict):
            _release_slot(leaf, slot)
    return cache


def make_cache_backend(engine):
    """Build the backend named by ``ServeConfig.cache``."""
    kind = engine.cfg.cache
    if kind == "contiguous":
        return ContiguousBackend(engine)
    if kind == "paged":
        return PagedBackend(engine)
    raise ValueError(f"unknown ServeConfig.cache {kind!r} "
                     f"(expected 'contiguous' or 'paged')")
