"""Multi-tenant admission: per-tenant queues + weighted-DLBC refill.

The serving batcher used to serve a single anonymous FIFO.  Multi-tenant
serving keeps ONE :class:`~repro.sched.executors.SlotExecutor` (one
device, one set of decode slots) and layers per-tenant queues over it:
the DLBC rule still decides *how many* requests the freed slots admit
each step (spawn only into idle workers, re-checked every iteration —
paper §3.2), and a weighted deficit-round-robin decides *which tenant*
each of those admissions comes from.

Deficit arithmetic (smoothed DRR, the nginx SWRR discipline):

* every admission round, each *backlogged* tenant's ``deficit`` grows by
  its ``weight``;
* the tenant with the largest deficit is served (FIFO within the
  tenant) and pays the total active weight ``W = sum(w_i)``;
* a tenant whose queue empties forfeits its deficit — idleness banks no
  credit, so a bursty tenant cannot save up and starve a steady one.

Properties (the property tests in ``tests/test_tenancy_property.py``
assert these over random weights/depths/slot counts):

* **work conservation** — while any queue is non-empty, every admission
  the base policy grants is used (no idle slot with queued work);
* **weighted fairness** — over any window where all tenants stay
  backlogged, tenant ``i``'s share of admissions converges to
  ``w_i / W`` (exact at every full cycle of ``W`` admissions for
  integer weights, ±1 admission inside a cycle);
* **no starvation** — a backlogged tenant with weight ``w_i`` is served
  at least once per ``ceil(W / w_i)`` admissions, so a request at
  queue position ``p`` waits at most ``(p + 1) * ceil(W / w_i)``
  admissions.

With a single tenant the deficit bookkeeping is inert — every admission
serves the one queue in FIFO order — so ``wdlbc`` reduces *step-for-step*
to the single-queue DLBC trace (the oracle test in
``tests/test_serve_regression.py`` pins this).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from .policy import POLICIES, SchedPolicy, get_policy


@dataclass
class TenantQueue:
    """One tenant: a FIFO of pending requests plus its DRR state."""

    name: str
    weight: float = 1.0
    queue: List[Any] = field(default_factory=list)
    #: DRR credit: grows by ``weight`` each backlogged round, pays the
    #: total active weight when served, forfeited while empty.
    deficit: float = 0.0
    #: lifetime admission count (slot-share accounting / tests)
    admitted: int = 0
    #: per-tenant SLO deadline in decode steps (0 = none): the batcher
    #: derives a request's expiry deadline and join timeout from this —
    #: a request still running ``slo_steps`` after arrival is expired so
    #: its slot frees for the tenant's queue instead of stalling it.
    slo_steps: int = 0
    #: per-token decode-cost ceiling in vtime steps (0 = derive from
    #: ``slo_steps``): the SLO monitor (repro.obs.monitor) counts a step
    #: whose decode cost exceeds this as burning the tenant's error
    #: budget — pure decode costs 1, a co-scheduled whole-prompt prefill
    #: costs ≈ 1 + prompt_len, which is the violation DLBC chunking
    #: exists to prevent.
    slo_cost: float = 0.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight}")

    def __len__(self) -> int:
        return len(self.queue)


class TenantRegistry:
    """Ordered registry of :class:`TenantQueue`\\ s (registration order is
    the DRR tie-break, so admission traces are deterministic)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._tenants: Dict[str, TenantQueue] = {}
        for name, w in (weights or {}).items():
            self.register(name, w)

    def register(self, name: str, weight: float = 1.0) -> TenantQueue:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        t = TenantQueue(name=name, weight=weight)
        self._tenants[name] = t
        return t

    def get(self, name: str) -> TenantQueue:
        return self._tenants[name]

    def submit(self, item: Any, tenant: str = "default") -> TenantQueue:
        """Enqueue ``item`` for ``tenant`` (auto-registering unknown
        tenants at weight 1.0, the anonymous-queue default)."""
        t = self._tenants.get(tenant)
        if t is None:
            t = self.register(tenant, 1.0)
        t.queue.append(item)
        return t

    def order(self) -> List[TenantQueue]:
        return list(self._tenants.values())

    def names(self) -> List[str]:
        return list(self._tenants)

    def total_queued(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def total_weight(self, backlogged_only: bool = True) -> float:
        ts = [t for t in self._tenants.values()
              if t.queue or not backlogged_only]
        return sum(t.weight for t in ts)

    def __iter__(self) -> Iterator[TenantQueue]:
        return iter(self._tenants.values())

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants


class WeightedRefillPolicy(SchedPolicy):
    """Weighted-DLBC admission: the base policy answers *how many* (the
    idle-slot arithmetic of Fig. 6 applied to device slots), the deficit
    round-robin answers *from which tenant*.

    ``decide``/``admit`` delegate to the wrapped base policy, so a
    ``WeightedRefillPolicy`` drops in anywhere a ``SchedPolicy`` goes;
    ``pick`` is the extra cross-tenant surface the generalized
    :meth:`repro.sched.executors.SlotExecutor.refill` consults.
    """

    name = "wdlbc"

    def __init__(self, base: Union[str, SchedPolicy, None] = "dlbc"):
        self.base = get_policy(base, default="dlbc")
        if self.base.escape_join:
            # admission joins are per-request completions; nothing to escape
            raise ValueError("weighted refill over an escape-join base "
                             "policy is not meaningful")

    @property
    def escape_join(self) -> bool:  # type: ignore[override]
        return self.base.escape_join

    def decide(self, pos, end, capacity):
        return self.base.decide(pos, end, capacity)

    def admit(self, idle, queued, total_slots):
        return self.base.admit(idle, queued, total_slots)

    def prefill_chunk_len(self, remaining, busy, cap):
        # chunk arithmetic is the base policy's, like grain_plan below
        return self.base.prefill_chunk_len(remaining, busy, cap)

    def grain_plan(self, n, capacity, telemetry=None):
        # host-side range work under a weighted policy chunks (and
        # steal-splits) exactly like its base: tenancy only changes
        # *whose* request fills a slot, never grain arithmetic
        return self.base.grain_plan(n, capacity, telemetry)

    # -- the cross-tenant choice ---------------------------------------------

    def pick(self, registry: TenantRegistry,
             k: int) -> List[Tuple[TenantQueue, Any]]:
        """Pop up to ``k`` requests across tenants by smoothed DRR.

        Work-conserving: returns exactly ``min(k, total queued)`` items.
        Mutates tenant queues and deficits.
        """
        picks: List[Tuple[TenantQueue, Any]] = []
        # idle tenants forfeit their credit before the round begins
        for t in registry:
            if not t.queue:
                t.deficit = 0.0
        while len(picks) < k:
            active = [t for t in registry.order() if t.queue]
            if not active:
                break
            w_total = sum(t.weight for t in active)
            best = active[0]
            for t in active:
                t.deficit += t.weight
                if t.deficit > best.deficit:  # ties → registration order
                    best = t
            best.deficit -= w_total
            best.admitted += 1
            picks.append((best, best.queue.pop(0)))
            if not best.queue:
                best.deficit = 0.0  # served dry: forfeit leftover credit
        return picks

    @staticmethod
    def starvation_bound(registry: TenantRegistry, tenant: str) -> int:
        """Max admissions between consecutive services of a backlogged
        ``tenant`` (every queued request is admitted within
        ``(position + 1) * bound`` admissions)."""
        t = registry.get(tenant)
        return math.ceil(registry.total_weight(backlogged_only=False)
                         / t.weight)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"WeightedRefillPolicy(base={self.base!r})"


# Register under the policy registry so `get_policy("wdlbc")` and the
# launcher's `--policy wdlbc` resolve like any other policy.
POLICIES["wdlbc"] = WeightedRefillPolicy


def ensure_weighted(policy: Union[str, SchedPolicy, None]
                    ) -> WeightedRefillPolicy:
    """Resolve ``policy`` to a :class:`WeightedRefillPolicy`, wrapping a
    plain base policy (``"dlbc"``, ``DLBC()``, …) when needed — multi-
    tenant refill always goes through the deficit round-robin, which is
    FIFO-transparent for a single tenant."""
    pol = get_policy(policy, default="wdlbc")
    if isinstance(pol, WeightedRefillPolicy):
        return pol
    return WeightedRefillPolicy(base=pol)
