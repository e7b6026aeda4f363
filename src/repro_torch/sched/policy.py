"""Scheduling policies and the canonical Fig. 6 chunk arithmetic.

This module is the ONLY place in the repo that knows how DLBC splits a
half-open iteration range among workers.  Every other surface — the IR
codegen in :mod:`repro.core.dlbc`, the host thread pool in
:mod:`repro.sched.executors`, the serving batcher's slot refill — calls
into these functions instead of re-deriving the arithmetic.

The Fig. 6 recurrence (paper §3.2, lines 7–16), for ``actualn`` remaining
iterations and ``idle`` idle workers:

    totWorkers = idle + 1                 # idle workers + the caller
    eqChunk    = actualn // totWorkers
    chunkEnd   = ii + actualn - eqChunk   # spawned chunks cover [ii, chunkEnd)
    rem        = actualn % totWorkers + idle
    while ii < chunkEnd:
        kx  = ii + eqChunk + rem // totWorkers
        spawn chunk [ii, kx); rem -= 1; ii = kx
    # caller executes [chunkEnd, hi) — the smallest chunk — then joins

which yields ``actualn % totWorkers`` front chunks of size ``eqChunk+1``,
the rest of size ``eqChunk``, and the caller keeping exactly ``eqChunk``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type, Union

from .capacity import CapacityProvider

# ---------------------------------------------------------------------------
# Fig. 6 scalar steps (consumed by the IR codegen in repro.core.dlbc)
# ---------------------------------------------------------------------------


def fig6_tot(idle: int) -> int:
    """Fig. 6 line 7: ``totWorkers = idleWorkers + 1`` (caller included)."""
    return idle + 1


def fig6_eq(actualn: int, tot: int) -> int:
    """Fig. 6 line 8: ``eqChunk = actualn / totWorkers``."""
    return actualn // tot


def fig6_chunk_end(ii: int, actualn: int, eq: int) -> int:
    """Fig. 6 line 9: spawned chunks end where the caller's chunk starts."""
    return ii + actualn - eq


def fig6_rem0(actualn: int, tot: int, idle: int) -> int:
    """Fig. 6 line 9: ``rem = actualn % totWorkers + workers`` — the counter
    whose integer division spreads the remainder one-per-chunk from the
    front."""
    return actualn % tot + idle


def fig6_next(ii: int, eq: int, rem: int, tot: int) -> int:
    """Fig. 6 line 10: ``kx = ii + eqChunk + rem / totWorkers``."""
    return ii + eq + rem // tot


# ---------------------------------------------------------------------------
# Chunk plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkPlan:
    """A concrete partition of ``[lo, hi)`` into spawned chunks plus the
    chunk the calling worker keeps for itself."""

    lo: int
    hi: int
    spawned: Tuple[Tuple[int, int], ...]
    caller: Tuple[int, int]

    @property
    def chunks(self) -> List[Tuple[int, int]]:
        """All chunks in range order (spawned first, caller last)."""
        return [*self.spawned, self.caller]

    @property
    def sizes(self) -> List[int]:
        return [b - a for a, b in self.chunks]


def chunk_plan(lo: int, hi: int, idle: int,
               caller_keeps_smallest: bool = True) -> ChunkPlan:
    """The canonical DLBC split of ``[lo, hi)`` given ``idle`` idle workers.

    With ``caller_keeps_smallest`` (the paper's parent block, Fig. 6 lines
    21–24) the caller executes the final, smallest chunk itself; with it
    disabled every chunk is spawned (LC-style: the parent only joins).
    """
    actualn = hi - lo
    tot = fig6_tot(idle)
    eq = fig6_eq(actualn, tot)
    chunk_end = fig6_chunk_end(lo, actualn, eq)
    rem = fig6_rem0(actualn, tot, idle)
    spawned: List[Tuple[int, int]] = []
    ii = lo
    while ii < chunk_end:
        kx = fig6_next(ii, eq, rem, tot)
        spawned.append((ii, kx))
        rem -= 1
        ii = kx
    caller = (chunk_end, hi)
    if not caller_keeps_smallest and chunk_end < hi:
        spawned.append(caller)
        caller = (hi, hi)
    return ChunkPlan(lo=lo, hi=hi, spawned=tuple(spawned), caller=caller)


def static_chunk_size(total: int, nchunks: int) -> int:
    """LC's static chunk size: ``ceil(total / nchunks)``, at least 1
    (Nandivada et al. loop chunking, paper Fig. 1(b))."""
    return max(1, -(-total // nchunks))


def static_plan(lo: int, hi: int, nchunks: int) -> ChunkPlan:
    """LC static chunking: ``nchunks`` contiguous ceil-sized chunks, all
    spawned; the caller only joins (paper Fig. 1(b) / Fig. 7(b))."""
    csize = static_chunk_size(hi - lo, nchunks)
    spawned = tuple((i, min(i + csize, hi)) for i in range(lo, hi, csize))
    return ChunkPlan(lo=lo, hi=hi, spawned=spawned, caller=(hi, hi))


# ---------------------------------------------------------------------------
# Grain plans (adaptive work stealing)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GrainPlan:
    """How a spawned chunk is carved into *stealable ranges*.

    ``initial`` is the items-per-range a chunk is pre-split into before
    any steal happens (``None`` = one range per chunk — fully lazy);
    ``split_min`` is the smallest range a thief is allowed to split (the
    re-split threshold): a range of fewer items is stolen whole or left
    alone, so splitting terminates and single items never churn.
    """

    initial: Optional[int] = None
    split_min: int = 2


class GrainController:
    """Closes the DLBC loop with runtime feedback: grain from steals.

    DLBC decides chunk sizes from *available workers* at spawn time; this
    controller decides how divisible those chunks stay afterwards.  Start
    coarse — ``initial = ceil(n / (k · workers))``, so each worker's
    chunk lands as ~``k`` ranges and per-task overhead is amortised over
    many items — and let runtime feedback prove imbalance: between loops
    the steal delta read off :class:`~repro.sched.telemetry.SchedTelemetry`
    says *someone went hungry*, and the recent latency spread
    (``recent_skew``) disambiguates why.  Steals with skewed item costs
    mean a coarser grain stranded a heavy head — halve the grain (double
    ``k``, up to ``k_max``).  Steals with uniform costs are end-of-loop
    churn (thieves passing tail scraps around) — treating them as
    imbalance would spiral the grain down to per-item tasks, so ``k``
    instead relaxes back toward ``k0``.  Both reads are unsynchronised
    by design — grain is a performance hint, and the benign-race
    discipline of the paper's idle-count probe (§3.2.1) applies
    verbatim.
    """

    def __init__(self, k: int = 1, k_max: int = 8, min_grain: int = 1,
                 split_min: int = 2, skew_ratio: float = 2.0):
        if k < 1 or k_max < k or min_grain < 1:
            raise ValueError(f"bad grain controller ({k=}, {k_max=}, "
                             f"{min_grain=})")
        self.k0 = self.k = k
        self.k_max = k_max
        self.min_grain = min_grain
        self.split_min = split_min
        #: p90/p50 item-latency ratio above which steals count as cost
        #: imbalance rather than churn
        self.skew_ratio = skew_ratio
        self._last_steals: Optional[int] = None

    def plan(self, n: int, workers: int, telemetry=None) -> GrainPlan:
        """Initial grain for an ``n``-item loop over ``workers`` workers,
        adapting ``k`` from the steal delta since the previous plan."""
        if telemetry is not None:
            steals = telemetry.steals  # benign racy read (advisory)
            if self._last_steals is not None:
                delta = steals - self._last_steals
                if delta > 0 and telemetry.recent_skew() >= self.skew_ratio:
                    if delta > workers:
                        self.k = min(self.k * 2, self.k_max)
                elif self.k > self.k0:
                    self.k -= 1  # churn or quiet: relax toward coarse
            self._last_steals = steals
        if n <= 0 or workers <= 0:
            return GrainPlan(None, self.split_min)
        initial = max(self.min_grain, -(-n // (self.k * workers)))
        return GrainPlan(initial, self.split_min)

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"GrainController(k={self.k}, k_max={self.k_max}, "
                f"split_min={self.split_min})")


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Decision:
    """One policy decision for the remaining range.

    ``plan is not None`` → take the parallel arm: spawn ``plan.spawned``,
    run ``plan.caller`` on the calling worker, then join (unless the
    policy escapes the join to an outer finish scope — DCAFE).

    ``plan is None`` → take the serial arm: run items one at a time,
    re-probing capacity every ``recheck_every`` items (0 = never re-probe,
    i.e. fully serial).
    """

    plan: Optional[ChunkPlan] = None
    recheck_every: int = 1


class SchedPolicy:
    """Protocol base for scheduling policies.

    ``decide`` drives range execution (pools, codegen); ``admit`` drives
    slot admission (the serving batcher), where each queued request is a
    single task and capacity is the idle-slot count.
    """

    name: str = "base"
    #: DCAFE: spawned tasks escape the per-loop join to one outer finish.
    escape_join: bool = False

    def decide(self, pos: int, end: int,
               capacity: CapacityProvider) -> Decision:
        raise NotImplementedError

    def admit(self, idle: int, queued: int, total_slots: int) -> int:
        """How many queued requests to place into idle slots right now."""
        raise NotImplementedError

    def grain_plan(self, n: int, capacity: CapacityProvider,
                   telemetry=None) -> GrainPlan:
        """How stealable ranges are carved from this policy's chunks on a
        work-stealing substrate (items per initial range + the re-split
        threshold).  The default keeps each chunk as one lazily-split
        range; DLBC-family policies route through their
        :class:`GrainController` so grain adapts to observed steals."""
        return GrainPlan()

    def prefill_chunk_len(self, remaining: int, busy: int, cap: int) -> int:
        """How many prompt tokens a prefilling slot should push through
        the model this step (chunked prefill in the serving batcher).

        ``remaining`` is the slot's unwritten prompt suffix, ``busy`` the
        number of slots currently decoding (the latency-sensitive work a
        long chunk would stall — the serving analogue of Fig. 6's idle
        probe, re-checked every step), ``cap`` the static width of the
        batched prefill launch buffer.  The base/static behaviour just
        fills the buffer; DLBC resizes against ``busy``."""
        if remaining <= 0:
            return 0
        return max(1, min(remaining, cap))

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{type(self).__name__}()"


class Serial(SchedPolicy):
    """No parallelism: run everything on the caller, never re-probe."""

    name = "serial"

    def decide(self, pos, end, capacity):
        return Decision(plan=None, recheck_every=0)

    def admit(self, idle, queued, total_slots):
        # one request at a time: admit only into a fully idle slot array
        return 1 if idle == total_slots and queued else 0


class LC(SchedPolicy):
    """Static loop chunking: split into ``capacity.total()`` ceil-sized
    chunks regardless of idleness; the caller only joins (Fig. 1(b))."""

    name = "lc"

    def decide(self, pos, end, capacity):
        return Decision(plan=static_plan(pos, end, capacity.total()))

    def admit(self, idle, queued, total_slots):
        # fixed batching: start only when a full batch of slots is free
        return min(idle, queued) if idle == total_slots else 0


class DLBC(SchedPolicy):
    """The paper's dynamic load-balanced chunking (Fig. 6):

    * idle workers present → ``chunk_plan`` over ``idle + 1`` shares, the
      caller keeping the smallest chunk;
    * none idle → serial block, re-probing every ``serial_check_every``
      items (§6(b) design alternative) and resuming the parallel arm when
      a worker frees up and ≥2 items remain.
    """

    name = "dlbc"

    def __init__(self, serial_check_every: int = 1,
                 caller_keeps_smallest: bool = True,
                 grain: Optional[GrainController] = None):
        self.serial_check_every = serial_check_every
        self.caller_keeps_smallest = caller_keeps_smallest
        #: per-policy-instance adaptive grain state (steal feedback is
        #: surface-local, like the rest of the policy's tuning knobs)
        self.grain = grain or GrainController()

    def decide(self, pos, end, capacity):
        idle = capacity.idle()
        if idle > 0:
            return Decision(plan=chunk_plan(
                pos, end, idle,
                caller_keeps_smallest=self.caller_keeps_smallest))
        return Decision(plan=None, recheck_every=self.serial_check_every)

    def admit(self, idle, queued, total_slots):
        # continuous batching: spawn only into idle slots, every step
        return min(idle, queued)

    def grain_plan(self, n, capacity, telemetry=None):
        return self.grain.plan(n, capacity.total(), telemetry)

    def prefill_chunk_len(self, remaining, busy, cap):
        # Fig. 6 applied to prompt tokens: with ``busy`` decoding slots
        # contending for the step, split the remaining prompt into
        # busy + 1 shares and push one share's worth this step — a long
        # prompt never holds latency-sensitive decodes hostage for more
        # than its fair chunk.  Re-probed every step (the serial-block
        # re-check), so the chunk grows back as decodes drain.  With no
        # decodes in flight, fill the launch buffer.
        if remaining <= 0:
            return 0
        if busy <= 0:
            return max(1, min(remaining, cap))
        plan = chunk_plan(0, remaining, busy,
                          caller_keeps_smallest=self.caller_keeps_smallest)
        first = plan.spawned[0] if plan.spawned else plan.caller
        share = max(1, first[1] - first[0])
        return max(1, min(share, remaining, cap))


class DCAFE(DLBC):
    """DLBC + aggressive finish elimination: identical chunking, but the
    spawned tasks escape the per-loop join to a single outer finish scope
    (the "1 finish, ~1000× fewer tasks" composition)."""

    name = "dcafe"
    escape_join = True


POLICIES: Dict[str, Type[SchedPolicy]] = {
    "serial": Serial,
    "lc": LC,
    "dlbc": DLBC,
    "dcafe": DCAFE,
}


def get_policy(policy: Union[str, SchedPolicy, None],
               default: str = "dlbc") -> SchedPolicy:
    """Resolve a policy name (or pass an instance through)."""
    if policy is None:
        policy = default
    if isinstance(policy, SchedPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; choose from {sorted(POLICIES)}")
