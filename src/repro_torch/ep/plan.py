"""Exchange planning: DLBC chunk arithmetic as an all-to-all send plan.

An expert-parallel dispatch is a loop over (token, choice) pairs whose
"workers" are expert shards: shard ``s`` owns experts
``[s·E/S, (s+1)·E/S)`` and a per-source *lane* of ``lane_capacity``
buffer rows in every other shard's incoming all-to-all block.  The
paper's two moves map directly:

* **DLBC** — the send-count matrix is a capacity-aware chunk plan: each
  source splits its routed pairs across destination lanes, and
  over-capacity residuals are *reassigned* to shards with idle lane
  capacity (via the canonical Fig. 6 ``chunk_plan`` split, re-probing
  residuals like the serial block re-probes idle workers) **before**
  the collective runs — instead of every shard dropping its own
  overflow after the fact.
* **AFE** — the plan prices one barrier per dispatch round; per-shard /
  per-expert joins never appear (see :mod:`repro.ep.dispatch`).

:class:`ExchangePlan` is the host-side artifact (telemetry, benches,
property tests); :func:`plan_exchange` owns the arithmetic, built on
:func:`repro.sched.chunk_plan` and
:class:`repro.sched.ExpertCapacityProvider` — the same residual/clamp
path every other admission surface uses.  The traced jnp form of the
reassignment in :func:`repro.ep.dispatch._ep_shard` is the *single
probe* of the single-host DLBC round 2 (one alternative expert per
token, static shapes oblige); this host plan re-probes until capacity
or overflow runs out, so its drop count is a lower bound on what the
traced round drops under extreme skew.  Each side's conservation
invariant is asserted in ``tests/test_ep.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..sched import ExpertCapacityProvider, chunk_plan


@dataclass(frozen=True)
class ExchangePlan:
    """The all-to-all plan for one dispatch round.

    ``send[i][j]`` — (token, choice) pairs source shard ``i`` puts in
    its lane to expert shard ``j`` (post-reassignment, ≤
    ``lane_capacity``).  ``recv`` is its transpose — what each shard
    will find in its incoming block.  ``reassigned[i]`` / ``dropped[i]``
    account for source ``i``'s overflow: pairs moved to an idle shard's
    lane before the collective, and pairs no lane had room for.

    Conservation (property-tested): for every source row,
    ``sum(send[i]) + dropped[i] == sum(counts[i])``.
    """

    counts: Tuple[Tuple[int, ...], ...]   # routed (src, dst) pairs
    send: Tuple[Tuple[int, ...], ...]     # planned (src, dst) pairs
    reassigned: Tuple[int, ...]
    dropped: Tuple[int, ...]
    lane_capacity: int

    @property
    def n_shards(self) -> int:
        return len(self.send)

    @property
    def recv(self) -> Tuple[Tuple[int, ...], ...]:
        """recv[j][i] — pairs shard j receives from source i."""
        return tuple(zip(*self.send))

    @property
    def sent_total(self) -> int:
        return sum(map(sum, self.send))

    @property
    def reassigned_total(self) -> int:
        return sum(self.reassigned)

    @property
    def dropped_total(self) -> int:
        return sum(self.dropped)

    def summary(self) -> dict:
        """The SchedTelemetry.exchange vocabulary for this plan."""
        return dict(sent=self.sent_total, received=self.sent_total,
                    reassigned=self.reassigned_total,
                    dropped=self.dropped_total, rounds=1)


def _spread_overflow(overflow: int, residual: List[int]) -> Tuple[List[int], int]:
    """Split ``overflow`` pairs across lanes with ``residual`` idle rows.

    The Fig. 6 arithmetic verbatim: the overflow range is chunk-planned
    over the idle lanes (``idle + 1`` shares, remainder spread from the
    front), each share clamped to its lane's residual, and the loop
    re-probes — the serial block's "re-check for idle workers" — until
    the overflow or the idle capacity runs out.  Returns per-lane
    additions and the dropped remainder (≥ 0 by construction: the
    residual clamp in :meth:`ExpertCapacityProvider.residual` means a
    full lane contributes zero shares, never a negative one).
    """
    add = [0] * len(residual)
    remaining = overflow
    while remaining > 0:
        idle = [j for j, r in enumerate(residual) if r - add[j] > 0]
        if not idle:
            break
        plan = chunk_plan(0, remaining, len(idle) - 1)
        for (a, b), j in zip(plan.chunks, idle):
            take = min(b - a, residual[j] - add[j])
            add[j] += take
            remaining -= take
    return add, remaining


def plan_exchange(counts: Sequence[Sequence[int]],
                  lane_capacity: int) -> ExchangePlan:
    """Build the send plan from routed (src, dst) pair counts.

    ``counts[i][j]`` — pairs source ``i``'s router assigned to experts
    living on shard ``j``.  Each lane admits up to ``lane_capacity``
    pairs (the :class:`ExpertCapacityProvider` admission rule with
    shards as "experts" and lane rows as slots); the overflow is
    reassigned across the same source's idle lanes, and only what no
    lane can hold is dropped.
    """
    S = len(counts)
    if lane_capacity < 0:
        raise ValueError(f"lane_capacity must be >= 0, got {lane_capacity}")
    cap = ExpertCapacityProvider(n_experts=S, slots_per_expert=lane_capacity)
    send: List[Tuple[int, ...]] = []
    reassigned: List[int] = []
    dropped: List[int] = []
    for i, row in enumerate(counts):
        if len(row) != S:
            raise ValueError(f"counts row {i} has {len(row)} lanes, "
                             f"expected {S}")
        row_arr = np.asarray([int(c) for c in row])
        kept = np.minimum(row_arr, lane_capacity).tolist()
        # both sides of the provider's clamp: overflow is what residual
        # swallowed, and what _spread_overflow re-plans across lanes
        overflow = int(np.sum(np.asarray(cap.overflow(row_arr))))
        residual = [int(r) for r in cap.residual(np.asarray(kept))]
        add, remaining = _spread_overflow(overflow, residual)
        send.append(tuple(k + a for k, a in zip(kept, add)))
        reassigned.append(overflow - remaining)
        dropped.append(remaining)
    return ExchangePlan(
        counts=tuple(tuple(int(c) for c in row) for row in counts),
        send=tuple(send), reassigned=tuple(reassigned),
        dropped=tuple(dropped), lane_capacity=lane_capacity)


def lane_capacity(tokens_per_shard: int, top_k: int, n_shards: int,
                  capacity_factor: float) -> int:
    """Rows per (src, dst) lane: the MoE capacity formula with shards as
    the expert dimension — ``ceil(T_local·K/S · cf)`` padded to 8 (TPU
    lane alignment), so ``S`` lanes jointly hold every locally routed
    pair whenever ``capacity_factor >= 1.0``."""
    c = int(math.ceil(tokens_per_shard * top_k / n_shards
                      * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)
