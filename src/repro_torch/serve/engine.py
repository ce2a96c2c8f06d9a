"""Serving engine: continuous batching with scheduler-driven slot admission.

Port of ``repro.serve.engine``'s greedy continuous path.  Pending requests
are the iteration space, ``cfg.slots`` decode slots are the threads, and
the admission policy (any registered scheduler) claims requests through
:class:`repro_torch.serve.queue.RequestQueue`.  Decode never stops for a
refill: every tick runs the full fixed batch, and a finished slot is
refilled in flight — the incoming prompt is prefilled at a bucketed width
(pad-masked, so mixed lengths batch safely) and its cache row is spliced
into the freed slot.  Greedy output equals per-request ``generate()``.

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
cache, as in the reference.

Not ported yet, each rejected when the engine is built: ``mode="rounds"``,
speculation (``spec``), temperature sampling, and the degradation knobs
``deadline_ticks`` / ``max_retries`` / ``on_pressure="shed"`` /
``"defer"``.  Errors raised while admitting or
decoding a request propagate; there is no per-request failure isolation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import runtime as rt
from repro_torch.kernels import quant
from repro_torch.models.model import Model
from repro_torch.serve.paged_cache import make_cache_backend
from repro_torch.serve.queue import Request, RequestQueue, as_requests
from repro_torch.serve.telemetry import RequestTelemetry, ServeReport

_KV_DTYPES = (torch.float32, torch.bfloat16, torch.float16) + tuple(
    torch_dtype(name) for name in quant.quant_dtypes())


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    eos_id: int = -1            # -1 = never stops early
    temperature: float = 0.0    # 0 = greedy, the only mode ported
    cache_dtype: str = "float32"
    # KV storage dtype; None = cache_dtype.  "int8" / "float8_e4m3fn"
    # store 1-byte values plus an f16 scale per (token, KV head)
    kv_dtype: Optional[str] = None
    slots: int = 4              # fixed batch slots for serve()
    refill_schedule: str = "static"  # admission policy
    mode: str = "continuous"    # "rounds" is not ported
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
    # an admission deadlock raises; "shed" / "defer" are not ported
    on_pressure: str = "raise"
    deadline_ticks: Optional[int] = None   # not ported: must stay None
    max_retries: int = 0                   # not ported: must stay 0
    spec: Optional[object] = None          # not ported: must stay None


def _check_ported(cfg: ServeConfig) -> None:
    """Reject the options of the reference engine this slice lacks."""
    todo = []
    if cfg.mode != "continuous":
        todo.append(f"mode={cfg.mode!r} (ROADMAP: temperature sampling "
                    f"and rounds mode)")
    if cfg.on_pressure not in ("raise", "shed", "defer"):
        raise ValueError(f"ServeConfig.on_pressure must be 'raise', 'shed' "
                         f"or 'defer', got {cfg.on_pressure!r}")
    if cfg.on_pressure != "raise":
        todo.append(f"on_pressure={cfg.on_pressure!r} (ROADMAP: serve fault "
                    f"degradation)")
    if cfg.spec is not None:
        todo.append("spec (ROADMAP: speculation)")
    if cfg.temperature != 0.0:
        todo.append(f"temperature={cfg.temperature} (ROADMAP: temperature "
                    f"sampling)")
    if cfg.deadline_ticks is not None or cfg.max_retries != 0:
        todo.append("deadline_ticks / max_retries (ROADMAP: serve fault "
                    "degradation)")
    if torch_dtype(cfg.kv_dtype or cfg.cache_dtype) not in _KV_DTYPES:
        raise ValueError(f"KV cache dtype {cfg.kv_dtype or cfg.cache_dtype!r}"
                         f" is not one of {list(_KV_DTYPES)}")
    if todo:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(todo))


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        _check_ported(cfg)
        self.model = model
        self.params = params
        self.cfg = cfg
        # storage dtype of every KV cache this engine allocates
        self.kv_dtype = torch_dtype(cfg.kv_dtype or cfg.cache_dtype)
        self._splice = None     # built lazily (needs the cache axis probe)
        # the cache backend persists across serve() calls, so the prefix
        # trie and page pool survive request churn; reset_cache() drops it
        self._backend = None
        # ScheduleStats of each admission pass (see serve())
        self.refill_stats: list = []
        self.last_report: Optional[ServeReport] = None

    def reset_cache(self) -> None:
        """Drop the persistent serve cache backend (page pool, prefix
        trie, KV pages); the next ``serve()`` call builds a fresh one."""
        self._backend = None

    def _prefill_padded(self, params, toks, lens):
        return self.model.prefill_padded(
            params, {"tokens": toks, "lengths": lens}, self.cfg.max_len,
            self.kv_dtype)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> np.ndarray:
        """Greedy next tokens: [B, V] logits -> [B] ids, one transfer."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------- generate

    def generate(self, batch: dict, max_new_tokens: int, *,
                 live: Optional[np.ndarray] = None,
                 lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """batch: {"tokens": [B, S_prompt]}.  Returns greedy tokens
        [B, max_new_tokens] (eos-padded).

        ``live``: optional [B] bool mask; False rows start done.
        ``lengths``: optional [B] true prompt lengths of right-padded
        mixed-length prompts (pad-masked prefill + per-row positions);
        None keeps the uniform-width prefill and a scalar cache length."""
        if lengths is None:
            logits, cache = self.model.prefill(
                self.params, batch, self.cfg.max_len, self.kv_dtype)
        else:
            logits, cache = self._prefill_padded(
                self.params, batch["tokens"], np.asarray(lengths, np.int32))
        b = np.asarray(batch["tokens"]).shape[0]
        out = np.full((b, max_new_tokens), self.cfg.eos_id, np.int32)
        done = (np.zeros((b,), bool) if live is None
                else ~np.asarray(live, bool))
        tok = self._argmax(logits)
        for t in range(max_new_tokens):
            out[:, t] = np.where(done, self.cfg.eos_id, tok)
            done |= tok == self.cfg.eos_id
            if done.all():
                break
            logits, cache = self.model.decode_step(self.params, tok[:, None],
                                                   cache)
            tok = self._argmax(logits)
        return out

    # ---------------------------------------------------------------- serve

    def serve(self, prompts: Sequence, max_new_tokens: int) -> list:
        """Serve any number of requests through ``cfg.slots`` fixed batch
        slots; returns one generated token array per request, in
        submission order (eos-padded to each request's token budget).

        ``prompts``: 1-D int arrays, or :class:`Request` objects (which may
        carry a per-request ``max_new_tokens``).  Admission runs under the
        scheduler named by ``cfg.refill_schedule``; its
        :class:`ScheduleStats` land in ``self.refill_stats`` and the run's
        latency/throughput telemetry in ``self.last_report``.
        """
        if self.cfg.slots < 1:
            raise ValueError(f"ServeConfig.slots must be >= 1, "
                             f"got {self.cfg.slots}")
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, "
                             f"got {max_new_tokens}")
        requests = as_requests(prompts)
        for r in requests:
            budget = (max_new_tokens if r.max_new_tokens is None
                      else min(r.max_new_tokens, max_new_tokens))
            if r.prompt_len + budget > self.cfg.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({r.prompt_len}) + token "
                    f"budget ({budget}) exceeds max_len "
                    f"{self.cfg.max_len} — the cache would overflow")
        return self._serve_continuous(requests, max_new_tokens)

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

    def _serve_continuous(self, requests: List[Request],
                          max_new_tokens: int) -> list:
        cfg = self.cfg
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
        telem = {r.rid: RequestTelemetry(rid=r.rid,
                                         prompt_len=r.prompt_len)
                 for r in requests}
        tick = 0
        decode_slot_ticks = 0   # (live slot, tick) pairs
        # rid of a request past the cfg.max_deferred_ticks aging bound:
        # while set, admission is barred for everyone else (see below)
        starving: Optional[int] = None

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

        def finish(slot: int) -> None:
            req = slot_req[slot]
            tm = telem[req.rid]
            tm.finish_tick = tick
            tm.finish_s = time.monotonic() - t0
            tm.decode_tokens = max(0, len(outputs[req.rid]) - 1)
            slot_req[slot] = None
            backend.finish(slot)

        while True:
            # refill every free slot in flight — no round barrier
            progress = False
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
                    progress = True
                    continue
                if starving is not None and req.rid != starving:
                    # aging barrier: a request past the deferral bound is
                    # waiting on pages, and every small admission here
                    # would snatch them first.  Hold this slot empty (no
                    # deferral penalty) until the starving request lands;
                    # running slots drain and free pages.
                    queue.push_back(s, req)
                    continue
                res = backend.admit(s, req, cap_of(req))
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
                first = int(torch.argmax(res.logits_row))
                slot_req[s] = req
                slot_cap[s] = cap_of(req)
                tok[s] = first
                outputs[req.rid] = [first]
                tm.admit_tick = tick
                tm.ttft_s = time.monotonic() - t0
                tm.stolen = stolen
                tm.prefill_tokens = res.prefill_tokens
                tm.prefix_hit_tokens = res.prefix_hit_tokens
                if first == cfg.eos_id or slot_cap[s] <= 1:
                    finish(s)

            live = [s for s in range(cfg.slots) if slot_req[s] is not None]
            if not live:
                if queue.pending == 0:
                    break
                if progress:
                    continue    # every admitted request finished on its
                                # first token; loop back for the rest
                # nothing running, nothing admitted, and no decode tick can
                # free pages (on_pressure="raise", the only policy ported)
                raise RuntimeError(
                    f"refill deadlock: {queue.pending} request(s) pending, "
                    f"no slot live, and no admission can proceed")

            # one batched decode tick over every slot; idle slots decode
            # too (their writes clamp at the cache end, their output is
            # dropped) so the batch shape never changes
            logits, backend.cache = self.model.decode_step(
                self.params, tok[:, None], backend.cache)
            tick += 1
            decode_slot_ticks += len(live)
            next_toks = self._argmax(logits)
            for s in live:
                rid = slot_req[s].rid
                nxt_tok = int(next_toks[s])
                tok[s] = nxt_tok
                outputs[rid].append(nxt_tok)
                if nxt_tok == cfg.eos_id or len(outputs[rid]) >= slot_cap[s]:
                    finish(s)

        results = []
        for req in requests:
            arr = np.full(cap_of(req), cfg.eos_id, np.int32)
            toks_r = outputs[req.rid] or []
            arr[: len(toks_r)] = toks_r
            results.append(arr)
        self.last_report = ServeReport(
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
        self.last_report.prefill_tokens = int(
            sum(t.prefill_tokens for t in telem.values()))
        self.last_report.decode_slot_ticks = decode_slot_ticks
        backend.fill_report(self.last_report)
        return results
