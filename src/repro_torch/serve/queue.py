"""Request queue with scheduler-driven slot admission.

The queue is the serving face of the paper's claim counter: pending
requests are the iteration space, decode slots are the threads, and the
admission policy — any scheduler from the registry — decides how slots
claim work and at what shared-counter cost.  The heavy lifting is
:func:`repro_torch.core.schedulers.plan_admission`, which runs the *real* policy
with slots as pool threads; the queue then serves each slot its claimed
backlog in claim order.

One serving reality the plan cannot know is *when* slots free up: a slot
whose backlog drains while a sibling still holds admitted-but-unstarted
requests would idle — the head-of-line stall the continuous engine exists
to kill.  ``next_for`` therefore steals from the deepest backlog when the
slot's own backlog is empty, taking the victim's most recently claimed
request (deque-back — the Chase-Lev thief orientation, as in
:class:`~repro_torch.core.schedulers.StealingScheduler`: the owner keeps the
work it would reach first), and counts the steal so the rebalancing shows
up in telemetry rather than silently hiding the plan's imbalance.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.schedulers import AdmissionPlan, plan_admission


@dataclasses.dataclass
class Request:
    """One generation request (token ids in, tokens out).

    ``rid`` is the submission index — the engine assigns it (leave the
    default); an explicit rid must match the request's position in the
    submitted sequence, since results and telemetry key on it.
    """

    rid: int = -1                            # -1 = assigned on submission
    prompt: np.ndarray = None                # 1-D int32 token ids
    max_new_tokens: Optional[int] = None     # None = the serve() default

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def as_requests(prompts: Sequence) -> List[Request]:
    """Normalize ``serve()`` input: 1-D token arrays or Request objects.

    ``max_new_tokens`` stays None unless the caller's Request set one; the
    engine resolves it against the serve-wide budget."""
    reqs = []
    for rid, p in enumerate(prompts):
        if isinstance(p, Request):
            if p.rid >= 0 and p.rid != rid:
                raise ValueError(
                    f"Request at position {rid} carries rid {p.rid}; rid is "
                    f"the submission index — leave it unset")
            reqs.append(Request(rid=rid, prompt=np.asarray(p.prompt, np.int32),
                                max_new_tokens=p.max_new_tokens))
        else:
            reqs.append(Request(rid=rid, prompt=np.asarray(p, np.int32)))
    for r in reqs:
        if r.prompt.ndim != 1 or r.prompt.shape[0] < 1:
            raise ValueError(
                f"request {r.rid}: prompt must be a non-empty 1-D token "
                f"array, got shape {r.prompt.shape}")
        if r.max_new_tokens is not None and r.max_new_tokens < 0:
            raise ValueError(
                f"request {r.rid}: max_new_tokens must be >= 0, "
                f"got {r.max_new_tokens}")
    return reqs


class RequestQueue:
    """Admission-planned queue feeding fixed decode slots.

    ``plan`` holds the policy's own :class:`ScheduleStats` (the admission
    FAA telemetry); ``steals`` counts serve-time rebalances on top of it.
    """

    def __init__(
        self,
        requests: Sequence[Request],
        slots: int,
        schedule: Union[str, object] = "faa",
        *,
        block_size: Optional[int] = None,
        cost_inputs=None,
    ):
        self.requests = list(requests)
        self.slots = slots
        self.plan: AdmissionPlan = plan_admission(
            len(self.requests), slots, schedule,
            block_size=block_size, cost_inputs=cost_inputs)
        self._backlogs = [collections.deque(self.plan.backlog_of(s))
                          for s in range(slots)]
        self.steals = 0

    @property
    def pending(self) -> int:
        return sum(len(d) for d in self._backlogs)

    def next_for(self, slot: int) -> Optional[tuple]:
        """Pop the next request for ``slot``: its own backlog first (claim
        order), else steal the deepest backlog's most recently claimed
        request (deque-back).  Returns ``(request, stolen)``, or None when
        the whole queue is drained."""
        own = self._backlogs[slot]
        if own:
            return self.requests[own.popleft()], False
        victim = max(range(self.slots), key=lambda s: len(self._backlogs[s]))
        if not self._backlogs[victim]:
            return None
        rid = self._backlogs[victim].pop()
        self.steals += 1
        return self.requests[rid], True

    def push_back(self, slot: int, request: Request) -> None:
        """Return an admitted-but-unstarted request to ``slot``'s backlog
        front (it stays next in claim order for that slot).

        This is the partial-admission escape hatch: the plan assumes one
        slot per request, but a paged engine may find a popped request's
        *page* demand exceeds the free pool mid-refill.  Pushing it back —
        rather than dropping it or spinning on ``next_for`` — keeps the
        accounting exact (``pending`` includes it again) and lets the
        refill loop retry once decode ticks free pages."""
        self._backlogs[slot].appendleft(request.rid)

    def requeue(self, rid: int) -> None:
        """Re-queue a cancelled request (deadline / poison retry) on the
        shallowest backlog — it rejoins the admission race at the back of
        that slot's claim order, behind work it already lost to."""
        tgt = min(range(self.slots), key=lambda s: len(self._backlogs[s]))
        self._backlogs[tgt].append(rid)

    def drop(self, rid: int) -> bool:
        """Remove a pending request from whichever backlog holds it (the
        load-shedding path); returns False when ``rid`` is not pending."""
        for d in self._backlogs:
            try:
                d.remove(rid)
                return True
            except ValueError:
                continue
        return False

    def pending_rids(self) -> List[int]:
        """Every pending rid, slot-major in claim order (for shed-victim
        selection and the defer policy's terminal sweep)."""
        return [rid for d in self._backlogs for rid in d]
