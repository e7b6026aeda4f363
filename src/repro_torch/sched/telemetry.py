"""Fig. 10-style scheduling telemetry: spawn/join counters plus latency
distributions, JSON-emittable for the benchmarks.

``SchedCounters`` is the shared counter core — the simulator's Fig. 10
counters (:class:`repro.core.runtime.Counters`) subclass it, so the IR
simulator, the host pools, and the serving batcher all report through
one counter vocabulary: *spawns* (``async`` analogue) and *joins*
(``finish`` analogue).

Distributions are reported two ways: point percentiles (p50/p90/p99,
back-compat) and a log-bucketed :class:`LogHistogram` with a tail
ratio (p99/p50) — most perf papers never report variance at all (see
ROADMAP, oracle-first harness), so every gated surface carries the
full shape, not just a median.  The histogram is built at ``summary()``
time from the bounded sample window: nothing new on the record path.
"""

from __future__ import annotations

import json
import math
import threading
from collections import deque
from dataclasses import dataclass, field
from itertools import islice
from typing import Deque, Dict, Iterable, List, Optional

#: Sliding window for latency samples: long-lived pools (the global data
#: pool runs for the whole training job) must not grow memory per item.
LATENCY_WINDOW = 8192


def diff_counters(new: Dict, old: Dict) -> Dict:
    """Windowed counter delta between two :meth:`counters_snapshot`
    dicts (``new`` taken after ``old``).  Nested dicts
    (``errors_by_site``, ``exchange``) subtract per key; keys whose
    delta is zero are dropped from nested maps so an incident window
    only reports the sites that moved *inside* it.  Raises if any
    monotone counter would go backwards — that means the snapshots are
    from different telemetry objects (or one was reset mid-window)."""
    out: Dict = {}
    for key, nv in new.items():
        ov = old.get(key)
        if isinstance(nv, dict):
            sub = {k: v - (ov or {}).get(k, 0) for k, v in nv.items()}
            if any(v < 0 for v in sub.values()):
                raise ValueError(
                    f"diff_counters: {key} went backwards ({sub})")
            sub = {k: v for k, v in sub.items() if v}
            if sub:
                out[key] = sub
        else:
            d = nv - (ov or 0)
            if d < 0:
                raise ValueError(
                    f"diff_counters: {key} went backwards "
                    f"({nv} < {ov})")
            out[key] = d
    return out


def percentile(data: Iterable[float], p: float) -> float:
    """Linear-interpolated percentile (numpy-compatible, dependency-free)."""
    data = list(data)
    if not data:
        return 0.0
    s = sorted(data)
    k = (len(s) - 1) * (p / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return float(s[int(k)])
    return s[f] + (s[c] - s[f]) * (k - f)


#: LogHistogram bucket geometry: bucket ``k`` holds samples in
#: ``(HIST_BASE_S * 2**(k-1), HIST_BASE_S * 2**k]`` seconds — 1 µs
#: resolution at the bottom, ~2.6 hours at the top (64 buckets).
HIST_BASE_S = 1e-6
HIST_BUCKETS = 64


class LogHistogram:
    """Log2-bucketed latency histogram: O(1) add, mergeable across
    repeats, percentile estimates within one bucket (≤ 2×) of exact.

    Point percentiles from a bounded sample window stay the precise
    numbers; the histogram is what survives aggregation — bucket counts
    from every repeat/worker merge exactly, where percentiles of
    percentiles are meaningless.
    """

    __slots__ = ("counts", "n", "total", "min", "max")

    def __init__(self):
        self.counts = [0] * HIST_BUCKETS
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    @staticmethod
    def bucket_of(seconds: float) -> int:
        if seconds <= HIST_BASE_S:
            return 0
        return min(HIST_BUCKETS - 1,
                   max(0, math.ceil(math.log2(seconds / HIST_BASE_S))))

    @staticmethod
    def bucket_edge_s(k: int) -> float:
        """Upper edge of bucket ``k`` in seconds."""
        return HIST_BASE_S * (2.0 ** k)

    def add(self, seconds: float):
        self.counts[self.bucket_of(seconds)] += 1
        self.n += 1
        self.total += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds

    def extend(self, samples: Iterable[float]):
        for s in samples:
            self.add(s)
        return self

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        if len(other.counts) != len(self.counts):
            raise ValueError(
                f"LogHistogram bucket-count mismatch: cannot merge "
                f"{len(other.counts)} buckets into {len(self.counts)}")
        for k, c in enumerate(other.counts):
            self.counts[k] += c
        self.n += other.n
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "LogHistogram":
        """Snapshot for windowed diffing (``new.diff(old)``)."""
        out = LogHistogram()
        out.counts = list(self.counts)
        out.n = self.n
        out.total = self.total
        out.min = self.min
        out.max = self.max
        return out

    def diff(self, older: "LogHistogram") -> "LogHistogram":
        """The per-interval histogram between two cumulative snapshots:
        ``newer.diff(older)`` subtracts bucket counts, so windowed
        p50/p99 come from snapshot diffing — never from resetting a
        live histogram under its writers.  Raises if ``older`` is not
        actually an earlier snapshot of the same cumulative series
        (negative bucket counts) or bucket geometries differ.

        The window's exact min/max are not recoverable from cumulative
        state; the diff bounds them by its own nonzero buckets, clamped
        by the cumulative extrema — percentiles keep the usual
        upper-bucket-edge contract."""
        if len(older.counts) != len(self.counts):
            raise ValueError(
                f"LogHistogram bucket-count mismatch: cannot diff "
                f"{len(self.counts)} buckets against {len(older.counts)}")
        out = LogHistogram()
        lo_k = hi_k = None
        for k, (a, b) in enumerate(zip(self.counts, older.counts)):
            d = a - b
            if d < 0:
                raise ValueError(
                    f"LogHistogram.diff: bucket {k} would go negative "
                    f"({a} - {b}) — 'older' is not an earlier snapshot")
            out.counts[k] = d
            if d:
                lo_k = k if lo_k is None else lo_k
                hi_k = k
        out.n = self.n - older.n
        out.total = self.total - older.total
        if out.n:
            lo_edge = self.bucket_edge_s(lo_k - 1) if lo_k > 0 else 0.0
            out.min = max(lo_edge, self.min if self.min != math.inf else 0.0)
            out.max = min(self.bucket_edge_s(hi_k), self.max)
        return out

    def percentile(self, p: float) -> float:
        """Upper bucket edge at percentile ``p`` (a ≤2× overestimate —
        consistent, so ratios of histogram percentiles are meaningful)."""
        if self.n == 0:
            return 0.0
        rank = (p / 100.0) * self.n
        seen = 0
        for k, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return min(self.bucket_edge_s(k), self.max)
        return self.max

    def tail_ratio(self, hi: float = 99.0, lo: float = 50.0) -> float:
        """Distribution-shape gate: histogram p``hi`` / p``lo`` (1.0 when
        empty or degenerate).  Bucket-edge ratios quantise to powers of
        two, which is exactly the robustness a CI gate wants."""
        denom = self.percentile(lo)
        return self.percentile(hi) / denom if denom > 0 else 1.0

    def summary(self) -> Dict:
        """Nonzero buckets keyed by upper edge in µs, plus the moments —
        the JSON shape the benchmark artifacts carry."""
        return dict(
            n=self.n,
            mean_ms=round((self.total / self.n) * 1e3, 4) if self.n else 0.0,
            min_ms=round(self.min * 1e3, 4) if self.n else 0.0,
            max_ms=round(self.max * 1e3, 4),
            p50_ms=round(self.percentile(50) * 1e3, 4),
            p90_ms=round(self.percentile(90) * 1e3, 4),
            p99_ms=round(self.percentile(99) * 1e3, 4),
            tail_p99_p50=round(self.tail_ratio(), 3),
            buckets_us={str(int(self.bucket_edge_s(k) * 1e6)): c
                        for k, c in enumerate(self.counts) if c},
        )


@dataclass
class SchedCounters:
    """The Fig. 10 dynamic counts, substrate-neutral."""

    spawns: int = 0      # tasks spawned (#async)
    joins: int = 0       # joins performed (#finish)
    barriers: int = 0
    steps: int = 0
    work: float = 0.0
    #: chunked-prefill accounting (serving batcher).  Deliberately NOT
    #: folded into spawns/joins: the serving AFE contract is one join
    #: per REQUEST, so chunk counts must never disturb the
    #: ``spawns == joins`` quiescence invariant the CI gates replay.
    prefill_chunks: int = 0   # prefill chunk launches executed in-place
    prefill_tokens: int = 0   # prompt tokens written through those chunks


@dataclass
class ExchangeCounters:
    """Per-round expert-parallel all-to-all accounting (``repro.ep``):
    how many (token, choice) pairs crossed the exchange, how many the
    DLBC plan *reassigned* to an idle expert shard before the collective
    (instead of dropping per-shard), and how many were dropped anyway.

    Rounds are counted at both edges: ``posted`` when a round's
    collectives are launched, ``completed`` when its single barrier
    lands.  Today every round blocks before the next, so
    ``posted == completed`` at quiescence — the double-buffered overlap
    (ROADMAP) will hold ``posted - completed`` in-flight rounds, and the
    obs spans for EP rounds emit both edges already.  The AFE invariant
    gated in CI is ``joins == completed`` on the owning telemetry — ONE
    FinishScope join per round, not one per expert or per shard."""

    sent: int = 0         # (token, choice) pairs sent into the all-to-all
    received: int = 0     # pairs received across all shards (== sent)
    reassigned: int = 0   # overflow pairs re-planned to an idle shard
    dropped: int = 0      # pairs no shard had capacity for
    posted: int = 0       # rounds whose collectives were launched
    completed: int = 0    # rounds whose barrier landed (each = one join)
    degraded_rounds: int = 0  # rounds that ran with >= 1 dead shard
    #                           (its lanes rerouted to live shards)

    @property
    def rounds(self) -> int:
        """Back-compat: completed rounds (the pre-split meaning — every
        round used to be counted only once its barrier landed)."""
        return self.completed

    @property
    def in_flight(self) -> int:
        return self.posted - self.completed

    def summary(self) -> Dict[str, int]:
        out = dict(sent=self.sent, received=self.received,
                   reassigned=self.reassigned, dropped=self.dropped,
                   posted=self.posted, completed=self.completed,
                   rounds=self.rounds)
        if self.degraded_rounds:
            out["degraded_rounds"] = self.degraded_rounds
        return out


@dataclass
class SchedTelemetry(SchedCounters):
    """Counters + item accounting + latency distributions.

    The record path is lock-free: ``deque.append`` on a bounded deque is
    GIL-atomic, so worker threads record without contention (counter
    increments likewise stay plain adds — they are only ever bumped from
    the scheduling thread, matching the old pool).  Readers snapshot the
    deque, retrying the rare copy-during-append race."""

    serial_items: int = 0     # items run in the serial fallback block
    parallel_items: int = 0   # items run inside spawned/caller chunks
    steals: int = 0           # work-stealing executor only (whole + split)
    splits: int = 0           # steals that split a range (adaptive grain):
    #                           the thief took the back half of a stealable
    #                           range; steals - splits = whole-task steals
    #: which worker each steal victimised (work-stealing executor only);
    #: sum of the histogram == steals at quiescence, and a rotating/
    #: randomised victim scan spreads the keys instead of hammering
    #: worker 0.  Bumped under ``lock`` like every cross-thread counter.
    steal_victims: Dict[int, int] = field(default_factory=dict)
    completions: int = 0      # spawned tasks that finished (quiescence:
    #                           spawns == completions + cancelled once every
    #                           join fired)
    errors: int = 0           # items/tasks that raised (collected into the
    #                           joining scope's MultipleExceptions — the
    #                           worker thread survives, the done event still
    #                           fires, the join never hangs)
    #: tasks skipped whole because their scope's CancelToken fired
    #: (fail_fast) — spawns == completions + cancelled at quiescence.
    cancelled: int = 0
    #: individual loop items skipped by cancellation (the item-level
    #: conservation side: intended items == executed + cancelled_items).
    cancelled_items: int = 0
    #: retry attempts consumed by a RetryPolicy (ckpt shards, serving
    #: requests, EP rounds) — bumped via :meth:`record_retry`.
    retries: int = 0
    #: worker threads that died (fault injection / crash containment);
    #: the executor redistributes the dead worker's queued work.
    worker_deaths: int = 0
    #: error counts keyed by emit site ("sched.item", "ckpt.shard",
    #: "serve.request", ...) — sums to ``errors``, so the obs crosscheck
    #: can gate error-instant conservation per site.
    errors_by_site: Dict[str, int] = field(default_factory=dict)
    #: first traceback string seen (the silent-swallow fix: one exemplar
    #: survives even where the raise site only counted before).
    first_error: Optional[str] = None
    #: per-tenant spawn/join counters (multi-tenant serving); keys are
    #: tenant names, values share the Fig. 10 counter vocabulary.  The
    #: conservation invariant — sum of per-tenant spawns/joins equals the
    #: global counters — is gated in CI (bench_tenants).
    tenants: Dict[str, SchedCounters] = field(default_factory=dict)
    #: expert-parallel all-to-all accounting (``repro.ep``); only EP
    #: dispatch surfaces grow it.  Bumped via :meth:`record_exchange`
    #: under ``lock`` like every cross-thread counter.
    exchange: ExchangeCounters = field(default_factory=ExchangeCounters)
    #: most recent samples only (bounded window — see LATENCY_WINDOW)
    latencies: Deque[float] = field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    #: guards counter increments that can race (several producer threads
    #: sharing one executor — the stress tests drive exactly that).  The
    #: latency path stays lock-free; single-threaded surfaces never
    #: contend on it.
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    # Back-compat aliases for the pre-sched ``PoolStats`` field names.
    @property
    def tasks_spawned(self) -> int:
        return self.spawns

    @tasks_spawned.setter
    def tasks_spawned(self, v: int):
        self.spawns = v

    def tenant(self, name: str) -> SchedCounters:
        """The per-tenant counter bucket for ``name`` (created on first
        use).  Only ever touched from the scheduling thread, like the
        global counters."""
        bucket = self.tenants.get(name)
        if bucket is None:
            bucket = self.tenants[name] = SchedCounters()
        return bucket

    def tenant_totals(self) -> Dict[str, int]:
        """Sums of the per-tenant counters — CI gates these against the
        globals (telemetry conservation)."""
        return dict(
            spawns=sum(c.spawns for c in self.tenants.values()),
            joins=sum(c.joins for c in self.tenants.values()),
            prefill_chunks=sum(c.prefill_chunks
                               for c in self.tenants.values()),
            prefill_tokens=sum(c.prefill_tokens
                               for c in self.tenants.values()),
        )

    def record_exchange(self, *, sent: int = 0, received: int = 0,
                        reassigned: int = 0, dropped: int = 0,
                        posted: int = 0, completed: int = 0,
                        degraded: int = 0,
                        rounds: Optional[int] = None):
        """Fold EP exchange counts in.  ``posted``/``completed`` are the
        round edges (a blocking round bumps both at once; the overlap
        path will bump ``posted`` at launch and ``completed`` at the
        barrier).  ``rounds=n`` is the legacy spelling of
        ``posted=n, completed=n``.  The caller is responsible for the
        matching join (``repro.ep.dispatch`` runs each round under a
        ``FinishScope``, so ``joins`` advances by exactly one per
        completed round — the AFE invariant CI gates)."""
        if rounds is not None:
            posted += int(rounds)
            completed += int(rounds)
        with self.lock:
            ex = self.exchange
            ex.sent += int(sent)
            ex.received += int(received)
            ex.reassigned += int(reassigned)
            ex.dropped += int(dropped)
            ex.posted += int(posted)
            ex.completed += int(completed)
            ex.degraded_rounds += int(degraded)

    def record_error(self, site: str, tb: Optional[str] = None):
        """One raising item/task at ``site``: bumps ``errors`` and the
        per-site breakdown under the lock, and keeps the FIRST traceback
        (the silent-swallow fix — an exemplar always survives).  The
        caller emits the matching ``sched.error`` instant (with
        ``args={"site": ...}``) so trace == telemetry holds per site."""
        with self.lock:
            self.errors += 1
            self.errors_by_site[site] = self.errors_by_site.get(site, 0) + 1
            if self.first_error is None and tb:
                self.first_error = tb

    def record_retry(self, site: str):
        """One retry attempt at ``site`` (the RetryPolicy calls this and
        emits the matching ``sched.retry`` instant)."""
        with self.lock:
            self.retries += 1

    def record_cancelled(self, tasks: int = 0, items: int = 0):
        """Tasks skipped whole / items skipped inside a partially-run
        chunk because the scope's CancelToken fired.  The caller emits
        the matching ``sched.cancel`` instant (weight = tasks)."""
        with self.lock:
            self.cancelled += int(tasks)
            self.cancelled_items += int(items)

    def record_latency(self, seconds: float):
        self.latencies.append(seconds)  # GIL-atomic, no lock on the hot path

    def _lat_snapshot(self) -> List[float]:
        while True:
            try:
                return list(self.latencies)
            except RuntimeError:  # deque mutated during copy; retry
                continue

    def recent_skew(self, n: int = 64, p: float = 90.0) -> float:
        """Cost-skew estimate over the most recent ``n`` latency samples:
        ``p``-th percentile / median (≥ 1.0 in practice; 1.0 when there
        are too few samples to judge).  O(n) — the grain controller reads
        this per loop, so it must not sort the whole window.  p90 rather
        than p99: a single OS-preempted item must not make a uniform
        loop look cost-skewed."""
        while True:
            try:
                recent = list(islice(reversed(self.latencies), n))
                break
            except RuntimeError:  # deque mutated during copy; retry
                continue
        if len(recent) < 8:
            return 1.0
        p50 = percentile(recent, 50)
        return percentile(recent, p) / p50 if p50 > 0 else 1.0

    def p50(self) -> float:
        return percentile(self._lat_snapshot(), 50)

    def p99(self) -> float:
        return percentile(self._lat_snapshot(), 99)

    def latency_histogram(self) -> LogHistogram:
        """Log-bucketed histogram of the current latency window (built
        here, at read time — the record path stays a deque append)."""
        return LogHistogram().extend(self._lat_snapshot())

    def summary(self) -> Dict:
        """Flat dict for benchmark tables / JSON artifacts."""
        hist = self.latency_histogram()
        out = dict(
            spawns=self.spawns,
            joins=self.joins,
            barriers=self.barriers,
            serial_items=self.serial_items,
            parallel_items=self.parallel_items,
            steals=self.steals,
            splits=self.splits,
            # quiescence invariant (gated from bench artifacts):
            # spawns == completions + cancelled once every join fired —
            # a raising task still completes (its exception is collected
            # by the joining scope), so errors is a subset of
            # completions, not a complement
            completions=self.completions,
            errors=self.errors,
            cancelled=self.cancelled,
            cancelled_items=self.cancelled_items,
            retries=self.retries,
            worker_deaths=self.worker_deaths,
            # serving chunked prefill: counted beside, never inside,
            # spawns/joins (AFE: one join per request, not per chunk)
            prefill_chunks=self.prefill_chunks,
            prefill_tokens=self.prefill_tokens,
            n_latencies=len(self.latencies),
            p50_ms=round(self.p50() * 1e3, 3),
            p99_ms=round(self.p99() * 1e3, 3),
            latency_hist=hist.summary(),
        )
        if self.errors_by_site:  # only surfaces that saw errors grow it
            out["errors_by_site"] = dict(sorted(self.errors_by_site.items()))
        if self.first_error is not None:
            out["first_error"] = self.first_error
        if self.steal_victims:  # only the work-stealing executor grows it
            out["steal_victims"] = {
                str(w): c for w, c in sorted(self.steal_victims.items())
            }
        if self.tenants:  # only multi-tenant surfaces grow the extra key
            out["tenants"] = {
                name: dict(spawns=c.spawns, joins=c.joins,
                           prefill_chunks=c.prefill_chunks,
                           prefill_tokens=c.prefill_tokens)
                for name, c in sorted(self.tenants.items())
            }
        if self.exchange.posted or self.exchange.completed:
            # only EP dispatch surfaces grow it
            out["exchange"] = self.exchange.summary()
        return out

    def counters_snapshot(self) -> Dict:
        """Cheap point-in-time copy of the monotone counters, in the
        shape :func:`repro.obs.export.crosscheck` understands.  Two
        snapshots diff (:func:`diff_counters`) into a *windowed* summary
        — the flight recorder crosschecks an incident's trace window
        against exactly such a delta, and the metrics plane derives
        per-interval rates the same way.  Taken under ``lock`` so a
        snapshot never tears a multi-field bump."""
        with self.lock:
            out: Dict = dict(
                spawns=self.spawns, joins=self.joins, steals=self.steals,
                splits=self.splits, completions=self.completions,
                errors=self.errors, cancelled=self.cancelled,
                retries=self.retries, worker_deaths=self.worker_deaths,
                prefill_chunks=self.prefill_chunks,
                prefill_tokens=self.prefill_tokens,
            )
            if self.errors_by_site:
                out["errors_by_site"] = dict(self.errors_by_site)
            ex = self.exchange
            if ex.posted or ex.completed:
                out["exchange"] = dict(posted=ex.posted,
                                       completed=ex.completed,
                                       degraded_rounds=ex.degraded_rounds)
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=1)

    def reset(self):
        self.spawns = self.joins = self.barriers = self.steps = 0
        self.work = 0.0
        self.serial_items = self.parallel_items = self.steals = 0
        self.splits = self.completions = self.errors = 0
        self.cancelled = self.cancelled_items = 0
        self.retries = self.worker_deaths = 0
        self.errors_by_site = {}
        self.first_error = None
        self.prefill_chunks = self.prefill_tokens = 0
        self.steal_victims = {}
        self.tenants = {}
        self.exchange = ExchangeCounters()
        self.latencies = deque(maxlen=LATENCY_WINDOW)  # atomic rebind
