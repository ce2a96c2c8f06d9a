"""Hardware topology descriptions.

The paper's empirical law keys on "core groups" — sets of cores sharing an L3
cache, communicating cheaply; cross-group coherence traffic rides a slower
medium (mesh interconnect / hyper-transport / UPI). We encode the paper's three
test platforms exactly, and map TPU meshes onto the same abstraction: an ICI
domain (pod) plays the core-group role, with cross-pod links the slow medium.

The port's card, the NVIDIA H100 SXM, has one table of rates
(``H100_PEAK_FLOPS``, ``H100_HBM_BW``, ``H100_LINK_BW``), which the
kernel bounds, the autotuner's priors and the roofline all read, and a
:class:`GpuTopology` of the cards that hold a batch's rows
(:func:`h100_topology`), the topology the microbatch count takes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class CoreGroup:
    """Cores that share the fast coherence domain (an L3 on CPU)."""

    cores: int


@dataclasses.dataclass(frozen=True)
class CpuTopology:
    """A machine = list of core groups + coherence latency parameters.

    Latencies are in abstract clock units matching the paper's measurements;
    they parameterize the ``R(S)`` term of ``L(A, S) = R(S) + E(A) + O``.
    """

    name: str
    groups: Sequence[CoreGroup]
    # R(S): cost to acquire ownership of the cache line holding the counter.
    # Contended atomics on modern x86 run to hundreds of cycles (Schweizer,
    # Besta & Hoefler 2020) — R dominates L, as the paper notes.
    r_same_core: float = 40.0      # line already in M/E state locally
    r_same_group: float = 150.0    # sibling core in the same L3 owned it
    r_cross_group: float = 500.0   # cross-L3 (mesh / HT / UPI hop)
    e_faa: float = 25.0            # E(A): execute the FAA on an owned line
    o_misc: float = 10.0           # O: misc (pipeline, retire)
    # OS scheduling-quota jitter: a thread occasionally loses its core for
    # roughly this many clocks (the paper's reason why B* < N/T).
    quota_clocks: float = 120_000.0
    quota_jitter: float = 0.35
    # sustained DRAM bandwidth in bytes/clock (per memory controller ×
    # sockets, NOT per L3 group) — saturation flattens thread scaling for
    # write-heavy unit tasks (paper's 2^16 unit_write tables).
    bw_bytes_per_clock: float = 24.0

    @property
    def total_cores(self) -> int:
        return sum(g.cores for g in self.groups)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of_core(self, core: int) -> int:
        acc = 0
        for gi, g in enumerate(self.groups):
            acc += g.cores
            if core < acc:
                return gi
        raise ValueError(f"core {core} out of range for {self.name}")

    def groups_used(self, n_threads: int) -> int:
        """Number of core groups touched when pinning n_threads round-robin
        across consecutive cores (the paper's fixed-affinity setup)."""
        used = 0
        acc = 0
        for g in self.groups:
            lo, hi = acc, acc + g.cores
            if lo < n_threads:
                used += 1
            acc = hi
        return max(1, used)

    def faa_cost(self, prev_core: int, core: int) -> float:
        """L = R(S) + E(A) + O for a FAA issued by `core` when `prev_core`
        last owned the counter's cache line."""
        if prev_core == core:
            r = self.r_same_core
        elif self.group_of_core(prev_core) == self.group_of_core(core):
            r = self.r_same_group
        else:
            r = self.r_cross_group
        return r + self.e_faa + self.o_misc


# The paper's three platforms (section "Test and statistics").
W3225R = CpuTopology(
    name="Intel W-3225R",
    groups=(CoreGroup(8),),  # 8 cores, single shared L3
)

GOLD5225R = CpuTopology(
    name="Intel Gold 5225R x2",
    groups=(CoreGroup(24), CoreGroup(24)),  # 2 sockets, 24 cores/L3 each
    r_cross_group=900.0,  # cross-socket UPI is the slowest medium tested
    bw_bytes_per_clock=44.0,  # two sockets = two memory controllers
)

AMD3970X = CpuTopology(
    name="AMD TR 3970X",
    groups=tuple(CoreGroup(4) for _ in range(8)),  # 8 CCX of 4 cores
    r_cross_group=550.0,
)

PLATFORMS = {t.name: t for t in (W3225R, GOLD5225R, AMD3970X)}


@dataclasses.dataclass(frozen=True)
class TpuTopology:
    """TPU analogue: chips grouped into ICI domains (pods).

    ``core group`` ↔ pod (fast ICI inside, slow DCN-class links across);
    ``thread``     ↔ chip participating in the balanced axis.
    """

    name: str
    chips_per_pod: int
    n_pods: int
    peak_flops: float = 197e12       # bf16 per chip (v5e)
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link
    # per-chunk dispatch overhead in seconds: grid-step / microbatch launch
    chunk_overhead_s: float = 2.0e-6

    @property
    def n_groups(self) -> int:
        return self.n_pods

    @property
    def total_chips(self) -> int:
        return self.chips_per_pod * self.n_pods


V5E_POD = TpuTopology(name="v5e-256", chips_per_pod=256, n_pods=1)
V5E_2POD = TpuTopology(name="v5e-2x256", chips_per_pod=256, n_pods=2)


# NVIDIA H100 SXM (data sheet), dense rates: the tensor cores' bf16 (and
# f16) and int8 / fp8 operations a second, f32 outside the tensor cores;
# HBM3 bytes a second; NVLink bytes a second a card
H100_PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12,
                   "int8": 1979e12, "fp8": 1979e12}
H100_HBM_BW = 3.35e12
H100_LINK_BW = 900e9


@dataclasses.dataclass(frozen=True)
class GpuTopology:
    """Cards that split a batch's rows, with the fields the microbatch
    count reads from a :class:`TpuTopology` (``total_chips``, ``ici_bw``,
    ``peak_flops``)."""

    name: str
    chips: int
    peak_flops: float                # bf16 per card
    ici_bw: float                    # bytes/s of the link between cards

    @property
    def total_chips(self) -> int:
        return self.chips


def h100_topology(chips: int = 1) -> GpuTopology:
    """``chips`` H100s on NVLink.  One card has no link to cross: its
    ``ici_bw`` is infinite, so a gradient all-reduce over it takes no
    time."""
    return GpuTopology(name=f"h100x{chips}", chips=chips,
                       peak_flops=H100_PEAK_FLOPS["bf16"],
                       ici_bw=H100_LINK_BW if chips > 1 else math.inf)
