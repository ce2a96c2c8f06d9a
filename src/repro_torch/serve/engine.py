"""Serving engine: continuous batching with scheduler-driven slot admission.

Port of ``repro.serve.engine``.  Two serve modes share one decode step.

``continuous`` (default): pending requests are the iteration space,
``cfg.slots`` decode slots are the threads, and the admission policy (any
registered scheduler) claims requests through
:class:`repro_torch.serve.queue.RequestQueue`.  Decode never stops for a
refill: every tick runs the full fixed batch, and a finished slot is
refilled in flight — the incoming prompt is prefilled at a bucketed width
(pad-masked, so mixed lengths batch safely) and its cache row is spliced
into the freed slot.

``rounds``: the round-barrier baseline.  Cohorts of up to ``slots``
requests, in submission order, ``generate()`` together and drain fully
before the next cohort starts; a cohort's rows are packed by a
ParallelFor under ``cfg.refill_schedule`` (``cfg.refill_threads``
threads), whose stats land in ``refill_stats``.  Where padding is unsafe
(the SSM and hybrid families) a cohort holds prompts of one length.

Greedy decoding (``temperature == 0``) takes the argmax.  Temperature
sampling draws each token from the stream of its (seed, request id,
step), as the reference does (``serve/sampling.py`` re-creates its
``jax.random`` draws on the logits' device), so a request's draws do not
depend on admission order, policy, slot count or the batch it sits in:
both modes give per-request ``generate(rids=...)``'s tokens wherever the
logits are the same (bf16 products whose shape follows the batch may
round otherwise on the card).  Only the [B] token ids of a tick leave
the device.

Two cache backends sit behind one seam (``serve/paged_cache.py``):
contiguous rows (``cache="contiguous"``) or a shared page pool with a
registry-driven free list and prefix reuse (``cache="paged"``).  A paged
admission that finds too few free pages is deferred: the request goes
back onto its slot's backlog and is retried after decode ticks free
pages, and a request deferred more than ``max_deferred_ticks`` times bars
every other admission until it lands.  The backend persists across
``serve()`` calls (the prefix trie survives request churn) until
``reset_cache()`` or a change of ``cfg.cache``.

On CUDA every attention call of a tick goes to a hand-written kernel:
the per-row decode to K2 (contiguous) or K3 (paged), the bucketed prefill
and a prefix hit's continuation prefill to K1 (see
``models/attention.py``).  A quantized ``kv_dtype`` ("int8",
"float8_e4m3fn") stores every KV cache the engine allocates as 1-byte
values with f16 scales, and the same calls go to K7, K8 and K10.  A
Mamba2 (SSM) model has no attention: each prompt of more than one token
is prefilled at its exact length through K12, 48 scans for mamba2-780m,
and every tick advances the per-slot state in plain torch; its cache
stays f32 whatever ``kv_dtype`` says, and its paged form allocates no
pages.  A MoE model (deepseek-v2, MLA attention) is also prefilled at the
exact prompt length (a pad would compete for expert capacity): every
prefill through K1 at MLA's (192, 128) head dims, every tick through K2 at
(576, 512) over the latent cache, and every MoE layer's three expert
products through K14; idle slots decode their stale tokens, which compete
for capacity as the reference's do.  MoE/MLA has no paged or quantized
cache, as in the reference.  A hybrid model (zamba2, SSD groups around
one shared attention block) is prefilled at the exact prompt length too:
each group's SSD layers through K12, the shared block through K1 (head
dim 80 at full width), every tick through K2 (K3 paged, K7 / K8 on a
1-byte cache) once a group; only its attention leaves are paged.  The
vision and encoder-decoder families (llama-3.2-vision, seamless-m4t) run
through ``generate`` only, with their patches or frames in the batch:
``serve()`` refuses them, as the reference does (a 1-D token prompt
cannot carry a modal input).  Their prefill and every tick of
``generate`` (a scalar cache length) send each self-, encoder- and
cross-attention call to K1.

Speculative decoding (``ServeConfig.spec``, a :class:`SpecConfig`): a
drafter proposes ``k`` tokens a live slot and tick (``k`` batched drafter
decode steps over its own contiguous cache), the target verifies all
``k + 1`` positions in one ``Model.verify_step`` (on CUDA one K2, K3, K7
or K8 call per position and layer, each the tick's), and the host accepts
the longest prefix that matches the target's argmax plus one corrected
token; both caches then roll back to the accepted lengths.  Output equals
greedy serve bit for bit.  Dense, non-MLA models only, as in the
reference.

Graceful degradation: with a fault plan installed
(``repro_torch.core.faults``), a poisoned admission or decode step fails
only its request (``isolate_failures``), which retries with exponential
backoff (``max_retries``, ``backoff``) before it goes terminal FAILED; a
poisoned draft degrades its slot's tick to plain decode; ``DecodeStall``
ticks charge the report's ``injected_stall_s``.  ``deadline_ticks``
cancels a request that decodes too long, and ``on_pressure`` picks what an
admission deadlock does: raise, shed the youngest deferred request, or
fail every request that cannot admit.  Every request ends with exactly one
terminal status.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import faults as _faults
from repro_torch.core import parallel_for as pf
from repro_torch.core import runtime as rt
from repro_torch.distributed import sharding
from repro_torch.kernels import quant
from repro_torch.models.model import FAMILIES, MODAL_INPUTS, Model
from repro_torch.serve import sampling
from repro_torch.serve.paged_cache import make_cache_backend
from repro_torch.serve.queue import Request, RequestQueue, as_requests
from repro_torch.serve.telemetry import RequestTelemetry, ServeReport

_KV_DTYPES = (torch.float32, torch.bfloat16, torch.float16) + tuple(
    torch_dtype(name) for name in quant.quant_dtypes())


@dataclasses.dataclass
class SpecConfig:
    """Draft-model speculation for the continuous decode loop.

    A cheap ``draft`` model proposes ``k`` tokens per live slot per tick
    (sequential drafter decode steps, batched across slots); the target
    verifies all k+1 positions in one batched forward
    (:meth:`repro_torch.models.model.Model.verify_step`), and greedy
    acceptance is longest-matching-prefix + one corrected token — so
    speculative serve output is bit-identical to target-only greedy
    serve, while one verification amortizes the per-token bookkeeping
    over the whole accepted span (the paper's grain trade at serving
    granularity).  ``k=None`` resolves from
    ``TuningContext.draft_span``, mirroring ``admission_block``.  Both
    models must support rollback-by-length-truncation
    (``Model.supports_speculation``: dense, non-MLA) and share a vocab;
    speculation is greedy-only.
    """

    draft: Model
    draft_params: object
    k: Optional[int] = None


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    eos_id: int = -1            # -1 = never stops early
    temperature: float = 0.0    # 0 = greedy
    cache_dtype: str = "float32"
    # KV storage dtype; None = cache_dtype.  "int8" / "float8_e4m3fn"
    # store 1-byte values plus an f16 scale per (token, KV head)
    kv_dtype: Optional[str] = None
    slots: int = 4              # fixed batch slots for serve()
    refill_schedule: str = "static"  # admission / refill-packing policy
    refill_threads: int = 4     # rounds mode: host threads for the packing
    mode: str = "continuous"    # "continuous" | "rounds" (round barrier)
    # requests claimed per admission FAA; None = ask the TuningContext
    admission_block: Optional[int] = None
    # prefill widths; None = powers of two from 8
    prefill_buckets: Optional[Sequence[int]] = None
    # ---- cache backend ----
    cache: str = "contiguous"   # "contiguous" | "paged"
    # tokens per KV page (must divide max_len); None = the tuning db's
    # pick for this cache (core/autotune_search's open paged bucket: the
    # analytic 16 on a miss or under REPRO_TUNING=off)
    page_size: Optional[int] = 16
    # pool pages; None = slots * max_len / page_size (same KV bytes as the
    # contiguous engine — shrink it to trade memory against deferrals)
    num_pages: Optional[int] = None
    prefix_cache: bool = True   # shared-prefix page reuse (paged + dense)
    # free-list claim policy; None = refill_schedule
    page_alloc_schedule: Optional[str] = None
    page_alloc_block: Optional[int] = None  # pages per claim FAA
    # aging bound on admission deferral: a request pushed back more than
    # this many times bars other admissions until it lands; None disables
    max_deferred_ticks: Optional[int] = 32
    # ---- graceful degradation ----
    # decode-tick deadline per admission: a request that has decoded this
    # many ticks without finishing is cancelled (slot freed, partial
    # tokens discarded) and retried or failed.  None = no deadline.
    deadline_ticks: Optional[int] = None
    # cancelled / poisoned admissions re-enter the queue this many times
    # before the request goes terminal FAILED
    max_retries: int = 0
    # retry k re-enters admission after backoff * 2**(k-1) ticks
    backoff: float = 1.0
    # what an admission deadlock (nothing live, nothing admittable) does:
    # "raise" a RuntimeError; "shed" the youngest deferred request (SHED)
    # and admit the rest; "defer": requests that can never admit go
    # terminal FAILED and the batch completes around them
    on_pressure: str = "raise"
    # an exception confined to one request's admission or decode marks
    # that request FAILED (its pages reclaimed) instead of destroying the
    # batch; False propagates everything
    isolate_failures: bool = True
    # speculative decoding (continuous mode, greedy only); None = plain
    spec: Optional[SpecConfig] = None


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        if torch_dtype(cfg.kv_dtype or cfg.cache_dtype) not in _KV_DTYPES:
            raise ValueError(f"KV cache dtype "
                             f"{cfg.kv_dtype or cfg.cache_dtype!r} is not "
                             f"one of {list(_KV_DTYPES)}")
        self.model = model
        self.params = params
        self.cfg = cfg
        # storage dtype of every KV cache this engine allocates
        self.kv_dtype = torch_dtype(cfg.kv_dtype or cfg.cache_dtype)
        self._splice = None     # built lazily (needs the cache axis probe)
        self._draft_splice = None   # the drafter's, likewise
        # the cache backend persists across serve() calls, so the prefix
        # trie and page pool survive request churn; reset_cache() drops it
        self._backend = None
        # ScheduleStats of each admission pass (see serve())
        self.refill_stats: list = []
        self.last_report: Optional[ServeReport] = None

    @staticmethod
    def _refuse_sharded() -> None:
        """An engine prefills whole caches and never cuts them: under a
        sequence-sharded decode policy over more than one rank it
        raises."""
        pol = sharding.active_policy()
        ranks = 1 if pol is None else math.prod(
            sharding.axis_sizes(pol.mesh).values())
        if pol is not None and pol.decode_seq_shard and ranks > 1:
            raise NotImplementedError(
                "Engine under ShardingPolicy(decode_seq_shard=True) over "
                f"{ranks} ranks: the engine keeps whole caches on one rank "
                "(ROADMAP: distributed and launch)")

    def reset_cache(self) -> None:
        """Drop the persistent serve cache backend (page pool, prefix
        trie, KV pages); the next ``serve()`` call builds a fresh one."""
        self._backend = None

    def _prefill_padded(self, params, toks, lens, model=None):
        return (model or self.model).prefill_padded(
            params, {"tokens": toks, "lengths": lens}, self.cfg.max_len,
            self.kv_dtype)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens: [..., V] logits -> [...] ids, one transfer."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------- sampling
    #
    # Every sampled token is a pure function of (seed, rid, step): the key
    # fold_in(fold_in(PRNGKey(seed), rid), step).  generate() and both
    # serve modes draw from the same streams, so temperature > 0 output
    # does not depend on admission order, policy, slot count or batch
    # composition.

    def _pick(self, logits: torch.Tensor, seed: int, rids,
              step) -> np.ndarray:
        """Next token of every row ([B, V] logits -> [B] ids, one
        transfer); ``step`` is a scalar (generate: every row at the same
        step) or a [B] vector (continuous: each slot at its own output
        length)."""
        if self.cfg.temperature <= 0.0:
            return self._argmax(logits)
        ids = sampling.sample(logits, seed, rids, step, self.cfg.temperature)
        return ids.to(torch.int32).cpu().numpy()

    def _sample_row(self, logits_row: torch.Tensor, seed: int, rid: int,
                    step: int) -> int:
        """One slot's next token from its row logits [V] (the admission's
        first token), from the same (seed, rid, step) stream as
        :meth:`_pick`."""
        return int(self._pick(logits_row[None], seed, rid, step)[0])

    # ------------------------------------------------------------- generate

    def generate(self, batch: dict, max_new_tokens: int, *, seed: int = 0,
                 live: Optional[np.ndarray] = None,
                 lengths: Optional[np.ndarray] = None,
                 rids: Optional[Sequence[int]] = None) -> np.ndarray:
        """batch: {"tokens": [B, S_prompt]}, with the family's modal input
        beside them (``"frames"`` [B, S_enc, d] for the encoder-decoder
        family, ``"patches"`` [B, vision_seq, d] for the vision family).
        Returns generated tokens [B, max_new_tokens] (eos-padded).

        ``live``: optional [B] bool mask; False rows start done.
        ``lengths``: optional [B] true prompt lengths of right-padded
        mixed-length prompts (pad-masked prefill + per-row positions);
        None keeps the uniform-width prefill and a scalar cache length.
        The vision and encoder-decoder families refuse ``lengths`` (the
        pad-masked prefill cannot carry their modal input; ROADMAP R8).
        ``rids``: optional [B] request ids naming each row's sampling
        stream at temperature > 0 (None: the row indices), so that a row
        samples the same tokens whatever batch it is in."""
        self._refuse_sharded()
        if lengths is None:
            logits, cache = self.model.prefill(
                self.params, batch, self.cfg.max_len, self.kv_dtype)
        else:
            logits, cache = self._prefill_padded(
                self.params, batch["tokens"], np.asarray(lengths, np.int32))
        b = len(batch["tokens"])
        rids = (np.arange(b, dtype=np.int32) if rids is None
                else np.asarray(rids, np.int32))
        out = np.full((b, max_new_tokens), self.cfg.eos_id, np.int32)
        done = (np.zeros((b,), bool) if live is None
                else ~np.asarray(live, bool))
        tok = self._pick(logits, seed, rids, 0)
        for t in range(max_new_tokens):
            out[:, t] = np.where(done, self.cfg.eos_id, tok)
            done |= tok == self.cfg.eos_id
            if done.all():
                break
            logits, cache = self.model.decode_step(self.params, tok[:, None],
                                                   cache)
            tok = self._pick(logits, seed, rids, t + 1)
        return out

    # ---------------------------------------------------------------- serve

    def serve(self, prompts: Sequence, max_new_tokens: int, *,
              seed: int = 0) -> list:
        """Serve any number of requests through ``cfg.slots`` fixed batch
        slots under ``cfg.mode``; returns one generated token array per
        request, in submission order (eos-padded to each request's token
        budget).

        ``prompts``: 1-D int arrays, or :class:`Request` objects (which may
        carry a per-request ``max_new_tokens``).  Admission (rounds mode:
        each cohort's packing) runs under the scheduler named by
        ``cfg.refill_schedule``; its :class:`ScheduleStats` land in
        ``self.refill_stats`` and the run's latency/throughput telemetry
        in ``self.last_report``.  ``seed`` names the sampling streams at
        temperature > 0.
        """
        self._refuse_sharded()
        if self.cfg.slots < 1:
            raise ValueError(f"ServeConfig.slots must be >= 1, "
                             f"got {self.cfg.slots}")
        if self.model.cfg.family in MODAL_INPUTS:
            servable = tuple(f for f in FAMILIES if f not in MODAL_INPUTS)
            raise ValueError(
                f"serve() handles token-only families {servable}; "
                f"{self.model.cfg.family!r} needs modal inputs — "
                f"use generate() directly")
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, "
                             f"got {max_new_tokens}")
        cfg = self.cfg
        if cfg.on_pressure not in ("raise", "shed", "defer"):
            raise ValueError(
                f"ServeConfig.on_pressure must be 'raise', 'shed' or "
                f"'defer', got {cfg.on_pressure!r}")
        if cfg.max_retries < 0:
            raise ValueError(f"ServeConfig.max_retries must be >= 0, "
                             f"got {cfg.max_retries}")
        if cfg.deadline_ticks is not None and cfg.deadline_ticks < 1:
            raise ValueError(f"ServeConfig.deadline_ticks must be >= 1, "
                             f"got {cfg.deadline_ticks}")
        spec_k = 0
        if cfg.spec is not None:
            # rollback is a pure length truncation: both models must be
            # dense non-MLA, share a vocab and decode greedily (acceptance
            # compares argmax streams)
            if cfg.mode != "continuous":
                raise ValueError(
                    "ServeConfig.spec needs mode='continuous' (the rounds "
                    "barrier has no per-slot decode loop to speculate in)")
            if cfg.temperature > 0:
                raise ValueError(
                    "speculative decoding is greedy-only: acceptance "
                    "compares draft/target argmax streams — set "
                    "temperature=0 or spec=None")
            for m, role in ((self.model, "target"), (cfg.spec.draft,
                                                      "draft")):
                if not m.supports_speculation:
                    raise ValueError(
                        f"{role} model {m.cfg.name!r} "
                        f"(family={m.cfg.family}"
                        f"{', MLA' if m.cfg.use_mla else ''}) cannot "
                        f"speculate: rollback needs every cache leaf to "
                        f"be a length-masked KV cache (dense, non-MLA)")
            if cfg.spec.draft.cfg.vocab_size != self.model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({cfg.spec.draft.cfg.vocab_size}) != "
                    f"target vocab ({self.model.cfg.vocab_size}) — "
                    f"acceptance compares token ids, the vocabularies "
                    f"must match")
            spec_k = self._spec_k()
            if spec_k < 0:
                raise ValueError(f"SpecConfig.k must be >= 0, got {spec_k}")
        requests = as_requests(prompts)
        for r in requests:
            budget = (max_new_tokens if r.max_new_tokens is None
                      else min(r.max_new_tokens, max_new_tokens))
            if r.prompt_len + budget > cfg.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({r.prompt_len}) + token "
                    f"budget ({budget}) exceeds max_len "
                    f"{cfg.max_len} — the cache would overflow")
            if spec_k and r.prompt_len + budget + spec_k - 1 > cfg.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({r.prompt_len}) + budget "
                    f"({budget}) + draft span ({spec_k}) - 1 exceeds "
                    f"max_len {cfg.max_len} — a verify step near the "
                    f"budget would write past the cache; shrink k or "
                    f"leave k tokens of headroom")
        if cfg.cache != "contiguous" and cfg.mode != "continuous":
            raise ValueError(
                f"cache={cfg.cache!r} needs mode='continuous' (the rounds "
                f"barrier has no slot lifecycle to page)")
        if cfg.mode == "continuous":
            return self._serve_continuous(requests, max_new_tokens, seed)
        if cfg.mode == "rounds":
            return self._serve_rounds(requests, max_new_tokens, seed)
        raise ValueError(f"unknown serve mode {cfg.mode!r}")

    # ------------------------------------------------- continuous batching

    def _bucket_width(self, prompt_len: int) -> int:
        """Prefill width for a prompt: the enclosing bucket where padding
        is safe, the exact length where it is not (the SSM family: a pad
        would enter the recurrent state)."""
        cfg = self.cfg
        if prompt_len > cfg.max_len:
            raise ValueError(f"prompt length {prompt_len} exceeds "
                             f"max_len {cfg.max_len}")
        if not self.model.pad_safe_prefill:
            return prompt_len
        if cfg.prefill_buckets:
            for w in sorted(cfg.prefill_buckets):
                if w >= prompt_len:
                    return min(int(w), cfg.max_len)
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest prefill "
                f"bucket {max(cfg.prefill_buckets)}")
        w = 8
        while w < prompt_len:
            w *= 2
        return min(w, cfg.max_len)

    def _ensure_splice(self):
        if self._splice is None:
            axes = self.model.cache_batch_axes(dtype=self.kv_dtype)
            self._splice = lambda c, pc, s: self.model.splice_cache(
                c, pc, s, axes=axes)

    def _ensure_draft_splice(self):
        if self._draft_splice is None:
            draft = self.cfg.spec.draft
            axes = draft.cache_batch_axes(dtype=self.kv_dtype)
            self._draft_splice = lambda c, pc, s: draft.splice_cache(
                c, pc, s, axes=axes)

    def _spec_k(self) -> int:
        """Resolved draft span: ``SpecConfig.k``, or the tuning context's
        grain choice (``TuningContext.draft_span``) when it is None.  0
        means no speculation."""
        spec = self.cfg.spec
        if spec is None:
            return 0
        if spec.k is not None:
            return spec.k
        return rt.tuning().draft_span()

    def _serve_continuous(self, requests: List[Request],
                          max_new_tokens: int, seed: int) -> list:
        cfg = self.cfg
        # fault injection resolves once per serve() call: one module-global
        # read when no plan is installed
        inj = _faults.active()
        block = cfg.admission_block
        if block is None:
            block = rt.tuning().admission_block(len(requests), cfg.slots)
        queue = RequestQueue(requests, cfg.slots, cfg.refill_schedule,
                             block_size=block)
        self.refill_stats = [queue.plan.stats]
        tok = np.zeros(cfg.slots, np.int32)
        slot_req: List[Optional[Request]] = [None] * cfg.slots
        slot_cap = np.zeros(cfg.slots, np.int64)
        outputs: List[Optional[list]] = [None] * len(requests)
        # ---- speculative state (inert when spec_k == 0) ----
        spec = cfg.spec
        spec_k = self._spec_k()
        draft_cache = None
        # host mirror of each slot's cache length (prompt + emitted - 1:
        # the last emitted token is consumed by the next tick), the
        # rollback target of both caches after each verify
        slot_len = np.zeros(cfg.slots, np.int32)
        drafted_total = accepted_total = degraded_ticks = 0
        if spec_k:
            self._ensure_draft_splice()
            draft_cache = spec.draft.set_cache_lengths(
                spec.draft.init_cache(cfg.slots, cfg.max_len, self.kv_dtype),
                np.zeros(cfg.slots, np.int32))
        telem = {r.rid: RequestTelemetry(rid=r.rid,
                                         prompt_len=r.prompt_len)
                 for r in requests}
        tick = 0
        decode_slot_ticks = 0   # (live slot, tick) pairs
        # rid of a request past the cfg.max_deferred_ticks aging bound:
        # while set, admission is barred for everyone else (see below)
        starving: Optional[int] = None
        # ---- degradation state (inert on the no-fault path) ----
        terminal: set = set()            # rids holding a terminal status
        not_before: Dict[int, int] = {}  # retry backoff: rid -> earliest tick
        engine_stall_s = 0.0             # injected decode-loop stall ledger

        def cap_of(req: Request) -> int:
            return (max_new_tokens if req.max_new_tokens is None
                    else min(req.max_new_tokens, max_new_tokens))

        # reuse the persistent backend (see reset_cache); a change of
        # cfg.cache builds the other one
        if self._backend is None or self._backend.name != cfg.cache:
            self._backend = make_cache_backend(self)
        backend = self._backend
        backend.begin_call()
        backend.validate(requests, cap_of)
        for req in requests:
            self._bucket_width(req.prompt_len)   # over-bucket prompts fail fast
        t0 = time.monotonic()

        def set_terminal(rid: int, status: str, reason: str = "") -> None:
            """Assign the request's terminal status, exactly once (a second
            assignment is an engine accounting bug and raises)."""
            nonlocal starving
            if rid in terminal:
                raise RuntimeError(
                    f"request {rid} assigned a second terminal status "
                    f"({telem[rid].status!r} then {status!r})")
            terminal.add(rid)
            tm = telem[rid]
            tm.status = status
            tm.fail_reason = reason
            if tm.finish_tick < 0:
                tm.finish_tick = tick
            if not np.isfinite(tm.finish_s):
                tm.finish_s = time.monotonic() - t0
            if starving == rid:
                starving = None

        def retry_or_fail(req: Request, reason: str) -> bool:
            """Requeue a cancelled / poisoned request after an exponential
            backoff (holding no slot) until its retry budget is spent, then
            make it terminal FAILED.  True when it was requeued."""
            tm = telem[req.rid]
            if tm.retries < cfg.max_retries:
                tm.retries += 1
                delay = max(1, int(round(cfg.backoff * 2 ** (tm.retries - 1))))
                not_before[req.rid] = tick + delay
                queue.requeue(req.rid)
                return True
            set_terminal(req.rid, "failed", reason)
            return False

        def finish(slot: int) -> None:
            req = slot_req[slot]
            tm = telem[req.rid]
            tm.finish_tick = tick
            tm.finish_s = time.monotonic() - t0
            tm.decode_tokens = max(0, len(outputs[req.rid]) - 1)
            slot_req[slot] = None
            slot_len[slot] = 0
            backend.finish(slot)
            set_terminal(req.rid, "ok")

        def cancel(slot: int, reason: str) -> None:
            """Cancel mid-decode: free the slot and its pages, drop the
            partial tokens, and retry or fail the request."""
            req = slot_req[slot]
            slot_req[slot] = None
            slot_len[slot] = 0
            backend.finish(slot)
            outputs[req.rid] = None
            retry_or_fail(req, reason)

        while True:
            # refill every free slot in flight — no round barrier
            progress = False
            delayed_pass = 0    # requests held out by retry backoff
            for s in range(cfg.slots):
                if slot_req[s] is not None:
                    continue
                nxt = queue.next_for(s)
                if nxt is None:
                    continue
                req, stolen = nxt
                tm = telem[req.rid]
                if cap_of(req) < 1:     # zero token budget: nothing to do
                    outputs[req.rid] = []
                    tm.admit_tick = tm.finish_tick = tick
                    tm.finish_s = time.monotonic() - t0
                    set_terminal(req.rid, "ok")
                    progress = True
                    continue
                if not_before.get(req.rid, 0) > tick:
                    # retry backoff: not yet eligible — to the back of the
                    # shallowest backlog (no deferral penalty), so it does
                    # not block the slot it landed on
                    queue.requeue(req.rid)
                    delayed_pass += 1
                    continue
                if starving is not None and req.rid != starving:
                    # aging barrier: a request past the deferral bound is
                    # waiting on pages, and every small admission here
                    # would snatch them first.  Hold this slot empty (no
                    # deferral penalty) until the starving request lands;
                    # running slots drain and free pages.
                    queue.push_back(s, req)
                    continue
                try:
                    if inj is not None:
                        inj.check_admission(req.rid)
                    res = backend.admit(s, req, cap_of(req))
                except Exception as e:
                    if not cfg.isolate_failures:
                        raise
                    # this admission died (a poisoned request, or a prefill
                    # error scoped to it): the backend has handed back its
                    # pages, and the request retries or fails alone
                    if retry_or_fail(
                            req, f"admission: {type(e).__name__}: {e}"):
                        delayed_pass += 1
                    else:
                        progress = True
                    continue
                if res is None:
                    # partial admission: the page demand exceeds the free
                    # pool right now — back on this slot's backlog (still
                    # next in its claim order), retried once decode ticks
                    # free pages
                    queue.push_back(s, req)
                    tm.deferred_ticks += 1
                    if (starving is None
                            and cfg.max_deferred_ticks is not None
                            and tm.deferred_ticks > cfg.max_deferred_ticks):
                        starving = req.rid
                    continue
                progress = True
                if req.rid == starving:
                    starving = None
                first = self._sample_row(res.logits_row, seed, req.rid, 0)
                slot_req[s] = req
                slot_cap[s] = cap_of(req)
                slot_len[s] = req.prompt_len
                tok[s] = first
                outputs[req.rid] = [first]
                if spec_k:
                    # the drafter prefills the same prompt into its own
                    # contiguous row: its proposals continue the target's
                    # stream
                    w = self._bucket_width(req.prompt_len)
                    dtoks = np.zeros((1, w), np.int32)
                    dtoks[0, : req.prompt_len] = req.prompt
                    _, dcache = self._prefill_padded(
                        spec.draft_params, dtoks,
                        np.asarray([req.prompt_len], np.int32), spec.draft)
                    draft_cache = self._draft_splice(draft_cache, dcache, s)
                tm.admit_tick = tick
                tm.ttft_s = time.monotonic() - t0
                tm.stolen = stolen
                tm.prefill_tokens = res.prefill_tokens
                tm.prefix_hit_tokens = res.prefix_hit_tokens
                if first == cfg.eos_id or slot_cap[s] <= 1:
                    finish(s)

            live = [s for s in range(cfg.slots) if slot_req[s] is not None]
            if not live and queue.pending == 0:
                break
            if not live:
                if progress:
                    continue    # every admitted request finished on its
                                # first token; loop back for the rest
                if delayed_pass:
                    # everything actionable waits out a retry backoff and
                    # nothing runs: charge an idle tick and retry
                    tick += 1
                    continue
                # admission deadlock: nothing running, nothing admitted,
                # and no decode tick can free pages
                if cfg.on_pressure == "shed":
                    # drop the youngest request already bounced on pressure
                    # (the oldest deferred one keeps its aging credit)
                    pend = queue.pending_rids()
                    deferred = [r for r in pend
                                if telem[r].deferred_ticks > 0]
                    victim = max(deferred) if deferred else max(pend)
                    queue.drop(victim)
                    set_terminal(victim, "shed",
                                 "load shed: admission deadlock under "
                                 "page pressure")
                    continue
                if cfg.on_pressure == "defer":
                    # requests that can never admit go terminal FAILED
                    for r in list(queue.pending_rids()):
                        queue.drop(r)
                        set_terminal(r, "failed",
                                     "page pressure: admission can never "
                                     "proceed")
                    continue
                raise RuntimeError(
                    f"refill deadlock: {queue.pending} request(s) pending, "
                    f"no slot live, and no admission can proceed")

            if inj is not None:
                # an injected straggler tick, charged to the report
                engine_stall_s += inj.engine_stall(tick)
            # one unit of per-token decode bookkeeping per (live slot,
            # tick); speculation emits more than one token per unit
            decode_slot_ticks += len(live)
            if spec_k:
                tick += 1
                # draft: k batched drafter steps.  Column 0 is each slot's
                # last emitted (unconsumed) token, columns 1..k the
                # drafter's greedy continuations
                draft_block = np.zeros((cfg.slots, spec_k + 1), np.int32)
                draft_block[:, 0] = tok
                for j in range(1, spec_k + 1):
                    dlogits, draft_cache = spec.draft.decode_step(
                        spec.draft_params, draft_block[:, j - 1:j],
                        draft_cache)
                    draft_block[:, j] = self._argmax(dlogits)
                # verify all k+1 positions: greedy[s, j] is the token a
                # plain tick would emit after consuming draft_block[s, :j+1]
                vlogits, backend.cache = self.model.verify_step(
                    self.params, draft_block, backend.cache)
                greedy = self._argmax(vlogits)
                # host acceptance: longest matching prefix + one corrected
                # token, capped by the remaining budget, cut at eos
                decisions = {}
                full_accept = False
                for s in live:
                    rid = slot_req[s].rid
                    degraded = False
                    if inj is not None:
                        try:
                            inj.check_draft(rid, len(outputs[rid]))
                        except Exception:
                            if not cfg.isolate_failures:
                                raise
                            # a poisoned draft degrades this slot's tick to
                            # plain decode (accept nothing, emit the
                            # corrected token): it loses the amortization
                            degraded = True
                    m = 0
                    if not degraded:
                        while (m < spec_k and int(draft_block[s, m + 1])
                               == int(greedy[s, m])):
                            m += 1
                    full_accept |= m == spec_k
                    rem = int(slot_cap[s]) - len(outputs[rid])
                    emit = [int(t) for t in greedy[s, : min(m + 1, rem)]]
                    if cfg.eos_id in emit:
                        emit = emit[: emit.index(cfg.eos_id) + 1]
                    decisions[s] = (emit, degraded)
                if full_accept:
                    # resync: a fully accepted row's drafter never consumed
                    # its k-th proposal; one more batched step feeds it (the
                    # rollback below masks it for every other row)
                    _, draft_cache = spec.draft.decode_step(
                        spec.draft_params, draft_block[:, -1:], draft_cache)
                for s, (emit, _) in decisions.items():
                    slot_len[s] += len(emit)
                # rollback: both caches truncate to the accepted lengths;
                # rejected positions stay masked until overwritten
                self.model.override_cache_lengths(backend.cache, slot_len)
                spec.draft.override_cache_lengths(draft_cache, slot_len)
                for s in live:
                    rid = slot_req[s].rid
                    emit, degraded = decisions[s]
                    tm = telem[rid]
                    tm.drafted_tokens += spec_k
                    tm.accepted_tokens += len(emit) - 1
                    drafted_total += spec_k
                    accepted_total += len(emit) - 1
                    degraded_ticks += degraded
                    if inj is not None:
                        base = len(outputs[rid])
                        try:
                            for off in range(len(emit)):
                                inj.check_decode(rid, base + off)
                        except Exception as e:
                            if not cfg.isolate_failures:
                                raise
                            cancel(s, f"decode: {type(e).__name__}: {e}")
                            continue
                    outputs[rid].extend(emit)
                    tok[s] = emit[-1]
                    if (emit[-1] == cfg.eos_id
                            or len(outputs[rid]) >= slot_cap[s]):
                        finish(s)
            else:
                # one batched decode tick over every slot; idle slots
                # decode too (their writes clamp at the cache end, their
                # output is dropped) so the batch shape never changes
                logits, backend.cache = self.model.decode_step(
                    self.params, tok[:, None], backend.cache)
                tick += 1
                # every slot draws from its request's (rid, step) stream in
                # one batched call (idle slots draw rid 0, dropped)
                rids_b = np.zeros(cfg.slots, np.int32)
                steps_b = np.zeros(cfg.slots, np.int32)
                for s in live:
                    rids_b[s] = slot_req[s].rid
                    steps_b[s] = len(outputs[slot_req[s].rid])
                next_toks = self._pick(logits, seed, rids_b, steps_b)
                for s in live:
                    rid = slot_req[s].rid
                    if inj is not None:
                        try:
                            inj.check_decode(rid, len(outputs[rid]))
                        except Exception as e:
                            if not cfg.isolate_failures:
                                raise
                            cancel(s, f"decode: {type(e).__name__}: {e}")
                            continue
                    nxt_tok = int(next_toks[s])
                    tok[s] = nxt_tok
                    outputs[rid].append(nxt_tok)
                    if (nxt_tok == cfg.eos_id
                            or len(outputs[rid]) >= slot_cap[s]):
                        finish(s)
            if cfg.deadline_ticks is not None:
                for s in range(cfg.slots):
                    req = slot_req[s]
                    if (req is not None and tick - telem[req.rid].admit_tick
                            >= cfg.deadline_ticks):
                        cancel(s, f"deadline: exceeded {cfg.deadline_ticks}"
                                  f" decode tick(s) since admission")

        missing = [r.rid for r in requests if r.rid not in terminal]
        if missing:
            raise RuntimeError(
                f"lost request(s) {missing}: the run ended with no terminal "
                f"status assigned — engine accounting bug")
        results = []
        for req in requests:
            arr = np.full(cap_of(req), cfg.eos_id, np.int32)
            toks_r = outputs[req.rid] or []
            arr[: len(toks_r)] = toks_r
            results.append(arr)
        rep = self.last_report = ServeReport(
            schedule=queue.plan.stats.schedule,
            mode="continuous",
            slots=cfg.slots,
            n_requests=len(requests),
            total_ticks=tick,
            wall_s=time.monotonic() - t0,
            total_tokens=int(sum(len(o) for o in outputs if o)),
            admission=queue.plan.stats,
            admission_steals=queue.steals,
            requests=[telem[r.rid] for r in requests],
        )
        rep.prefill_tokens = int(sum(t.prefill_tokens for t in telem.values()))
        backend.fill_report(rep)
        rep.failed_requests = sum(
            1 for t in telem.values() if t.status == "failed")
        rep.shed_requests = sum(
            1 for t in telem.values() if t.status == "shed")
        rep.retries = sum(t.retries for t in telem.values())
        rep.injected_stall_s = (
            engine_stall_s + queue.plan.stats.injected_stall_s
            + sum(st.injected_stall_s for st in rep.page_alloc_stats))
        rep.spec_k = spec_k
        rep.drafted_tokens = drafted_total
        rep.accepted_tokens = accepted_total
        rep.draft_degraded_ticks = degraded_ticks
        rep.decode_slot_ticks = decode_slot_ticks
        return results

    # ------------------------------------------------------ round barrier

    def _serve_rounds(self, requests: List[Request], max_new_tokens: int,
                      seed: int) -> list:
        """Round-barrier serve: cohorts of up to ``slots`` requests in
        submission order, each a padded ``generate()`` that drains before
        the next cohort starts.  Pad-masked prefill batches mixed widths;
        where padding is unsafe a cohort holds prompts of one length (the
        first pending request's)."""
        cfg = self.cfg
        pending = list(requests)
        results: list = [None] * len(requests)
        self.refill_stats = []
        telem = {r.rid: RequestTelemetry(rid=r.rid,
                                         prompt_len=r.prompt_len)
                 for r in requests}
        t0 = time.monotonic()
        tick = 0
        total_tokens = 0
        while pending:
            if self.model.pad_safe_prefill:
                round_reqs = pending[: cfg.slots]
                pending = pending[cfg.slots:]
                width = self._bucket_width(
                    max(r.prompt_len for r in round_reqs))
            else:
                width = pending[0].prompt_len
                round_reqs = [r for r in pending
                              if r.prompt_len == width][: cfg.slots]
                taken = {r.rid for r in round_reqs}
                pending = [r for r in pending if r.rid not in taken]
            caps = [(max_new_tokens if r.max_new_tokens is None
                     else min(r.max_new_tokens, max_new_tokens))
                    for r in round_reqs]
            round_new = max(caps)
            # the full slot count, so the batch shape is constant; unused
            # rows carry zeros, start dead and are dropped below
            tokens = np.zeros((cfg.slots, width), np.int32)
            lengths = np.ones(cfg.slots, np.int32)

            def pack(j: int) -> None:
                r = round_reqs[j]
                tokens[j, : r.prompt_len] = r.prompt
                lengths[j] = r.prompt_len

            self.refill_stats.append(pf.parallel_for_stats(
                pack, len(round_reqs),
                n_threads=max(1, min(cfg.refill_threads, len(round_reqs))),
                schedule=cfg.refill_schedule, block_size=1, layer="serve"))
            # each row samples its request's own (seed, rid, step) stream;
            # padding rows take rid 0 and never emit
            live = np.arange(cfg.slots) < len(round_reqs)
            rids = [r.rid for r in round_reqs]
            rids += [0] * (cfg.slots - len(rids))
            out = self.generate({"tokens": tokens}, round_new, seed=seed,
                                live=live, lengths=lengths, rids=rids)
            now = time.monotonic() - t0
            for j, r in enumerate(round_reqs):
                arr = out[j][: caps[j]].copy()   # eos-padded by generate()
                results[r.rid] = arr
                # emitted: up to and including the first eos, as the
                # continuous mode counts
                hits = np.nonzero(arr == cfg.eos_id)[0]
                emitted = int(hits[0]) + 1 if hits.size else caps[j]
                tm = telem[r.rid]
                tm.admit_tick = tick
                tm.ttft_s = now      # round granularity: the barrier
                tm.finish_s = now
                tm.finish_tick = tick + round_new
                tm.decode_tokens = max(0, emitted - 1)
                total_tokens += emitted
            tick += round_new
        self.last_report = ServeReport(
            schedule=cfg.refill_schedule
            if isinstance(cfg.refill_schedule, str)
            else getattr(cfg.refill_schedule, "name", "custom"),
            mode="rounds",
            slots=cfg.slots,
            n_requests=len(requests),
            total_ticks=tick,
            wall_s=time.monotonic() - t0,
            total_tokens=total_tokens,
            admission=self.refill_stats[0] if self.refill_stats else None,
            admission_steals=0,
            requests=[telem[r.rid] for r in requests],
        )
        return results
