"""CapacityProvider — what "idle workers" means on each execution surface.

The paper's ``Runtime.retIdleWorkers()`` is an *unsynchronised* read of
scheduler state (§3.2.1): two tasks sampling at the same instant may see
the same count, a benign race the policy tolerates by construction.
Every provider here preserves that contract — ``idle()`` is a plain read,
never a lock acquisition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable


@runtime_checkable
class CapacityProvider(Protocol):
    """Idle/total worker counts for one execution substrate."""

    def idle(self) -> int:
        """How many workers could take a task right now (racy read)."""
        ...

    def total(self) -> int:
        """Substrate size: threads, simulated workers, or device slots."""
        ...


@dataclass
class FixedCapacity:
    """A constant capacity — unit tests and cost modelling."""

    idle_n: int
    total_n: int

    def idle(self) -> int:
        return self.idle_n

    def total(self) -> int:
        return self.total_n


class SimWorkerCapacity:
    """Simulated workers of the discrete-event runtime
    (:class:`repro.core.runtime.Scheduler`, duck-typed to avoid a
    sched→core import cycle).  ``idle`` reads the scheduler's idle set at
    the current simulated instant — the benign race is preserved because
    same-instant events observe the same set."""

    def __init__(self, sched):
        self._sched = sched

    def idle(self) -> int:
        return len(self._sched.idle)

    def total(self) -> int:
        return self._sched.n_workers


class PoolCapacity:
    """Host thread-pool idleness: an intentionally unlocked read of the
    executor's idle counter (:class:`repro.sched.executors.ThreadExecutor`)."""

    def __init__(self, executor):
        self._ex = executor

    def idle(self) -> int:
        return self._ex._idle  # intentionally unlocked (paper §3.2.1)

    def total(self) -> int:
        return self._ex.n_workers


class ExpertCapacityProvider:
    """Per-expert slot capacity for MoE dispatch — the device-side
    analogue of :class:`SlotCapacity`: expert ``e`` owns ``slots_per_expert``
    capacity-buffer rows, and a (token, choice) pair is a task that may be
    admitted into one of them.

    This is where the MoE drop/admission arithmetic lives (it used to be a
    private policy inside ``repro.models.moe``): LC admits a token iff its
    static slot position fits (``admit_mask``), DLBC re-routes overflow
    against the residual capacity (``residual`` — the "idle workers" read
    of this substrate, per expert).  The array-valued reads are traced
    under jit; like every provider here they are plain unsynchronised
    reads of scheduler state (paper §3.2.1) — in SPMD form the "benign
    race" becomes reading the round-1 load before round-2 admission.
    """

    def __init__(self, n_experts: int, slots_per_expert: int):
        self.n_experts = n_experts
        self.slots_per_expert = slots_per_expert

    def total(self) -> int:
        return self.n_experts * self.slots_per_expert

    def idle(self) -> int:
        """Before any dispatch every slot is idle; per-expert residuals
        during dispatch come from :meth:`residual` (traced arrays)."""
        return self.total()

    def admit_mask(self, pos):
        """Admission rule: a (token, choice) with running slot index
        ``pos`` inside its chosen expert is admitted iff a slot exists.
        Works on jnp arrays (static-shape SPMD) and plain ints alike."""
        return pos < self.slots_per_expert

    def residual(self, load):
        """Idle slots per expert given the observed per-expert ``load``
        (an (E,) array) — the capacity round-2 re-routing admits against.

        Clamped at zero: a load exceeding an expert's capacity (or the
        provider's *total* capacity) yields zero idle slots, never a
        negative residual that round-2 arithmetic would mis-admit
        against.  The clamped excess is not silently lost — it is
        reported by :meth:`overflow` as a dropped count (the EP exchange
        planner consumes both sides of this split)."""
        import torch

        return torch.clamp(torch.as_tensor(self.slots_per_expert - load),
                           min=0)

    def overflow(self, load):
        """Per-expert dropped count: the positive part of
        ``load - slots_per_expert`` — what the :meth:`residual` clamp
        swallowed.  ``residual(load) - overflow(load)`` reconstructs the
        raw (possibly negative) headroom, so conservation
        ``sum(min(load, C)) + sum(overflow) == sum(load)`` holds even
        when the total load exceeds :meth:`total` capacity."""
        import torch

        return torch.clamp(torch.as_tensor(load - self.slots_per_expert),
                           min=0)


class SlotCapacity:
    """Device decode slots of the serving batcher: a slot is idle when no
    request occupies it."""

    def __init__(self, slots: List[Optional[object]]):
        self._slots = slots

    def idle(self) -> int:
        return len(self.idle_indices())

    def idle_indices(self) -> List[int]:
        """Idle slot indices, lowest first (the Fig. 6 refill priority:
        oldest queued request → lowest slot)."""
        return [i for i, r in enumerate(self._slots) if r is None]

    def total(self) -> int:
        return len(self._slots)
