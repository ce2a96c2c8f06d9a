"""Pluggable ParallelFor scheduling policies.

The paper's claim — ParallelFor latency is governed by how often the shared
atomic counter is hit — makes the *claiming policy* the interesting axis, so
it is a registry, not a branch.  Six policies ship; ``register_scheduler``
adds more (see ``docs/schedulers.md``).

======================  =====================================================
policy                  shared-counter FAA behavior
======================  =====================================================
``static``              zero — contiguous pre-partition, no rebalancing
``faa``                 ``ceil(N/B) + T`` — the paper's baseline
``guided``              ``O(T log N)`` — shrinking claims (Taskflow for_each)
``cost_model``          as ``faa`` with B from the trained rational model
``hierarchical``        ``ceil(N/(fanout·B)) + T`` — group-local counters,
                        shared line touched only on group refill
``stealing``            zero — per-thread deques, randomized stealing
======================  =====================================================
"""

from repro_torch.core.schedulers.admission import (AdmissionPlan, TidRecordingPool,
                                             plan_admission)
from repro_torch.core.schedulers.base import (AtomicCounter, PoolErrorGroup,
                                        Recorder, ScheduleStats, Scheduler,
                                        ThreadPool, available_schedulers,
                                        empty_stats, get_scheduler,
                                        raise_task_errors, register_scheduler)
from repro_torch.core.schedulers.cost_model import CostModelScheduler
from repro_torch.core.schedulers.faa import FaaScheduler
from repro_torch.core.schedulers.guided import GuidedScheduler
from repro_torch.core.schedulers.hierarchical import HierarchicalScheduler
from repro_torch.core.schedulers.static import StaticScheduler
from repro_torch.core.schedulers.stealing import StealingScheduler

__all__ = [
    "AdmissionPlan",
    "AtomicCounter",
    "CostModelScheduler",
    "FaaScheduler",
    "GuidedScheduler",
    "HierarchicalScheduler",
    "PoolErrorGroup",
    "Recorder",
    "ScheduleStats",
    "Scheduler",
    "StaticScheduler",
    "StealingScheduler",
    "ThreadPool",
    "TidRecordingPool",
    "available_schedulers",
    "empty_stats",
    "get_scheduler",
    "plan_admission",
    "raise_task_errors",
    "register_scheduler",
]
