"""Core: the paper's contribution — scheduling policies + the FAA cost
model — as a reusable layer."""

from repro_torch.core import atomic_sim, cost_model, schedulers, topology

__all__ = ["atomic_sim", "cost_model", "schedulers", "topology"]
