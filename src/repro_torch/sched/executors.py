"""Executors: substrates that run work under a pluggable SchedPolicy.

* :class:`ThreadExecutor` — host thread pool (FIFO task queue), the
  generalisation of the old ``repro.data.pool.DLBCPool``.  ``run_loop``
  is the paper's three-block structure (chunked / parent / serial) with
  the *policy* deciding which arm to take at each step.
* :class:`WorkStealingExecutor` — per-worker deques under per-deque
  locks, with **lazy steal-driven splitting**: tasks carry ``(lo, hi)``
  ranges, the owner claims items off the front one at a time, a thief
  steals the back half of the largest stealable range, and the split
  recurses — grain adapts to observed imbalance with zero tuning.  Same
  ``run_loop``.
* :class:`FinishScope` — DCAFE on the host: spawned chunks escape their
  per-loop join to one outer scope (one join for many loops).
* :class:`SlotExecutor` — admission scheduling over fixed device decode
  slots for the continuous batcher (requests are single tasks; capacity
  is the idle-slot count).
"""

from __future__ import annotations

import queue
import random
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from itertools import count
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..obs import metrics as obs_metrics
from ..obs import monitor as obs_monitor
from ..obs import trace as obs
from . import faults
from .capacity import PoolCapacity, SlotCapacity
from .policy import GrainPlan, SchedPolicy, get_policy
from .telemetry import SchedTelemetry
from .tenancy import TenantRegistry, ensure_weighted

# Tracing contract (repro.obs): an instant event is emitted at every
# site that bumps a SchedTelemetry counter — same name, same integer
# weight — so the exporter can re-derive spawns/joins/steals/splits/
# completions/errors from the trace and CI can assert they agree
# (docs/obs.md).  Worker busy time is spans with cat="worker"; stalls
# (join_stall, park, steal latency) are cat="sched".  Every emit is a
# single module-flag read when tracing is disabled.


#: Always-on metrics plane (repro.obs.metrics): handles are looked up
#: once here, then bumped per LOOP (never per item) — the same
#: scheduling-edge granularity that keeps tracing inside its 5% budget.
_MX_LOOPS = obs_metrics.counter("sched.loops")
_MX_ITEMS = obs_metrics.counter("sched.items")
_MX_LOOP_S = obs_metrics.histogram("sched.loop_s")

#: Max TaskErrors *stored* per waitable (latch / task event).  Counts
#: stay exact past the cap — ``MultipleExceptions.count`` and the
#: injected == collected gates never saturate — only the retained
#: exemplar objects are bounded, so an error storm cannot OOM the join.
_ERROR_CAP = 256


@dataclass
class TaskError:
    """One collected task/item failure: the cause plus where it ran —
    the per-task record a :class:`MultipleExceptions` aggregates (X10
    finish semantics: every finish knows *which* asyncs failed)."""

    exc: BaseException
    site: str = "sched.item"
    worker: Optional[int] = None
    lo: int = -1
    hi: int = -1
    tb: str = ""

    def summary(self) -> str:
        where = f"[{self.lo},{self.hi})" if self.lo >= 0 else "?"
        w = f"w{self.worker}" if self.worker is not None else "caller"
        return (f"{type(self.exc).__name__}({self.exc}) at {self.site} "
                f"{where} on {w}")


class MultipleExceptions(RuntimeError):
    """The aggregate a finish rethrows (X10 ``MultipleExceptions``):
    every exception of every transitively spawned task — across helped,
    stolen, and split ranges — with per-task cause, chunk range, and
    worker id.  ``count`` is exact even when the stored ``errors`` list
    was capped at ``_ERROR_CAP``."""

    def __init__(self, errors: Sequence[TaskError],
                 count: Optional[int] = None):
        self.errors: List[TaskError] = list(errors)
        self.count = int(count) if count is not None else len(self.errors)
        first = self.errors[0].summary() if self.errors else "?"
        super().__init__(f"{self.count} task exception(s); first: {first}")
        if self.errors:
            self.__cause__ = self.errors[0].exc


class TaskCancelled(Exception):
    """Internal unwind signal: a running chunk observed its scope's
    :class:`CancelToken` and stopped early.  Never escapes the executor
    — the worker counts the task cancelled, not completed."""


class CancelToken:
    """Cooperative cancellation flag threaded through chunk execution
    (``fail_fast``): the first collected error trips it, sibling chunks
    observe it at their next item boundary and skip the rest."""

    __slots__ = ("_event",)

    def __init__(self):
        self._event = threading.Event()

    def cancel(self):
        self._event.set()

    def cancelled(self) -> bool:
        return self._event.is_set()


def _collect_errors(events: Sequence[Any]) -> Tuple[List[TaskError], int]:
    """Gather collected TaskErrors (exact count, capped storage) from a
    set of joined waitables."""
    errors: List[TaskError] = []
    total = 0
    for ev in events:
        errs = getattr(ev, "errors", None)
        if errs:
            errors.extend(errs)
            total += getattr(ev, "error_count", len(errs))
    return errors[:_ERROR_CAP], total


class TaskEvent(threading.Event):
    """Per-task done event that also carries the task's collected
    errors.  A task runs on exactly one worker, so recording needs no
    lock beyond the GIL."""

    def __init__(self):
        super().__init__()
        self.errors: List[TaskError] = []
        self.error_count = 0

    def record_error(self, err: TaskError):
        self.error_count += 1
        if len(self.errors) < _ERROR_CAP:
            self.errors.append(err)


class RangeLatch:
    """Countdown latch for one submitted range: fires once every item of
    ``[lo, hi)`` has executed, across however many steal-splits the range
    underwent.  Event-compatible (``wait``/``is_set``) so
    :class:`FinishScope` and ``run_loop`` joins treat it exactly like the
    per-task :class:`TaskEvent` it coalesces — one waitable per
    submitted range instead of one per item, so DCAFE joins stay
    O(ranges).  Also the range's error sink: owner, thieves, and helpers
    all record raising items here, so the join sees every failure no
    matter which worker ran the item."""

    __slots__ = ("_remaining", "_lock", "_event", "errors", "error_count")

    def __init__(self, n_items: int):
        self._remaining = n_items
        self._lock = threading.Lock()
        self._event = threading.Event()
        self.errors: List[TaskError] = []
        self.error_count = 0
        if n_items <= 0:
            self._event.set()

    def record_error(self, err: TaskError):
        with self._lock:
            self.error_count += 1
            if len(self.errors) < _ERROR_CAP:
                self.errors.append(err)

    def discharge(self, n: int):
        """Credit ``n`` executed items (workers call this once per drain
        session, not once per item)."""
        if n <= 0:
            return
        with self._lock:
            self._remaining -= n
            if self._remaining <= 0:
                self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def is_set(self) -> bool:
        return self._event.is_set()


class RangeTask:
    """A stealable slice of one loop: run ``fn(items[j])`` for ``j`` in
    ``[lo, hi)``.  ``lo``/``hi`` are only ever mutated under the owning
    worker's deque lock: the owner claims ``lo`` forward one item at a
    time, a thief truncates ``hi`` to steal the back half.  All splits of
    a submitted range share one :class:`RangeLatch`."""

    __slots__ = ("items", "fn", "lo", "hi", "latch", "split_min", "active",
                 "token")

    def __init__(self, items: Sequence, fn: Callable, lo: int, hi: int,
                 latch: RangeLatch, split_min: int = 2,
                 token: Optional[CancelToken] = None):
        self.items = items
        self.fn = fn
        self.lo = lo
        self.hi = hi
        self.latch = latch
        self.split_min = max(2, split_min)
        #: the owning scope's fail_fast cancel token (None = run to
        #: completion); splits inherit it with the latch
        self.token = token
        #: True while an owning worker's drain session holds this task
        #: (set/read only under the holding deque's lock).  A helper may
        #: take the last item of — and remove — only *inactive* tasks;
        #: an active task's last item belongs to its already-awake owner.
        self.active = False

    def run(self, j: int):
        fn = self.fn
        if self.items is None:  # single-callable submit() wrapper
            fn()
        else:
            fn(self.items[j])


@dataclass(frozen=True)
class JoinOutcome:
    """Typed result of :meth:`FinishScope.wait`: distinguishes "timed
    out" (work still in flight — the scope is NOT discharged, re-wait or
    abandon explicitly) from "done with failures" (every task finished,
    some raised) from a clean finish."""

    status: str  # "done" | "failed" | "timeout"
    errors: Tuple[TaskError, ...] = ()
    error_count: int = 0
    pending: int = 0  # unfired waitables (timeout only)

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def failed(self) -> bool:
        return self.status == "failed"

    @property
    def timed_out(self) -> bool:
        return self.status == "timeout"

    def raise_if_failed(self) -> "JoinOutcome":
        if self.status == "failed":
            raise MultipleExceptions(list(self.errors), self.error_count)
        if self.status == "timeout":
            raise TimeoutError(
                f"finish scope timed out with {self.pending} waitable(s) "
                "still pending")
        return self


#: FinishScope failure semantics (the paper's exception extension):
#: ``run_to_completion`` attempts every spawned item and aggregates all
#: failures at the join; ``fail_fast`` trips a CancelToken on the first
#: failure so sibling chunks skip their remaining items (skipped work is
#: accounted: spawns == completions + cancelled).
FAIL_MODES = ("run_to_completion", "fail_fast")


class FinishScope:
    """Collects escaped joins (DCAFE): ``with executor.finish() as f:``
    runs many loops but performs ONE join at scope exit.  Holds any
    waitable with Event semantics — per-task :class:`TaskEvent`\\ s from
    the FIFO pool, per-range :class:`RangeLatch`\\ es from the
    work-stealing pool.

    Exception contract (X10 finish semantics): the scope collects the
    exceptions of ALL transitively spawned tasks — including helped,
    stolen, and split ranges — and :meth:`join` rethrows them as ONE
    :class:`MultipleExceptions`.  AFE may move *where* the join happens;
    it never changes *whether* an exception surfaces."""

    def __init__(self, telemetry: Optional[SchedTelemetry] = None,
                 fail_mode: str = "run_to_completion"):
        if fail_mode not in FAIL_MODES:
            raise ValueError(f"fail_mode {fail_mode!r} not in {FAIL_MODES}")
        self._events: List[Any] = []
        self.telemetry = telemetry
        self.fail_mode = fail_mode
        #: fail_fast: the token sibling chunks poll; the first recorded
        #: error cancels it.  None in run_to_completion mode.
        self.token: Optional[CancelToken] = (
            CancelToken() if fail_mode == "fail_fast" else None)

    def add(self, events: Sequence[Any]):
        self._events.extend(events)

    def pending(self) -> int:
        """Non-blocking probe: waitables added but not yet fired.  The
        stall watchdog (repro.obs.monitor) polls this from its own
        thread, so a scope wedged with no one in ``wait()`` is still
        observable from outside."""
        return sum(1 for e in self._events if not e.is_set())

    def wait(self, timeout: Optional[float] = None) -> JoinOutcome:
        """Join with a deadline and a typed outcome.  On timeout the
        scope keeps its events (nothing is discharged, no join is
        counted) so the caller can re-wait, cancel, or abandon with full
        knowledge; on completion the join is counted once and any
        collected task errors are returned (not raised — that is
        :meth:`join`)."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with obs.trace_span("sched", "join_stall"):
            for ev in self._events:
                if deadline is None:
                    ev.wait()
                else:
                    left = deadline - time.perf_counter()
                    if left <= 0 or not ev.wait(max(0.0, left)):
                        pending = sum(1 for e in self._events
                                      if not e.is_set())
                        obs_monitor.on_join_timeout(self, pending,
                                                    timeout or 0.0)
                        return JoinOutcome("timeout", pending=pending)
        errors, total = _collect_errors(self._events)
        self._events.clear()
        if self.telemetry is not None:
            with self.telemetry.lock:
                self.telemetry.joins += 1
            obs.instant("sched", "join")
        if total:
            obs_monitor.on_join_failed(self, total)
            return JoinOutcome("failed", tuple(errors), total)
        return JoinOutcome("done")

    def join(self):
        """The finish: wait for everything, then rethrow collected task
        exceptions as one :class:`MultipleExceptions`."""
        self.wait().raise_if_failed()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # an exception is already in flight: still quiesce (tasks
            # must not outlive the scope) but never mask the original
            self.wait()
            return False
        self.join()
        return False


class ThreadExecutor:
    """DLBC worker pool — the paper's runtime policy on real host threads.

    Host-side work in a TPU stack (data shard preparation, checkpoint I/O,
    request batching) is CPU task-parallelism, so DCAFE applies literally:
    the idle count is read without a lock (the benign race, §3.2.1), the
    policy decides between the chunked/parent arms and the re-probing
    serial arm, and telemetry mirrors Fig. 10 (spawns/joins).
    """

    #: Max items per spawned task; ``None`` = one task per planned chunk.
    #: The work-stealing variant narrows this so thieves have something
    #: to steal when cost skew piles up in one chunk.
    chunk_grain: Optional[int] = None

    def __init__(self, n_workers: int = 4,
                 telemetry: Optional[SchedTelemetry] = None):
        self.n_workers = n_workers
        self._q: "queue.Queue" = queue.Queue()
        self._idle = n_workers  # racy read by design (paper §3.2.1)
        self._idle_lock = threading.Lock()
        #: by-name policy resolutions, cached per executor so policy
        #: state — the DLBC grain controller's steal-feedback baseline —
        #: persists across run_loop calls instead of dying with a fresh
        #: instance every loop (racy insert is benign: one winner stays)
        self._policy_cache: Dict[str, SchedPolicy] = {}
        self.telemetry = telemetry or SchedTelemetry()
        self.capacity = PoolCapacity(self)
        self._threads = [
            # named threads: the trace exporter shows one track per
            # worker, labelled by executor class and worker index
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{type(self).__name__}-w{i}")
            for i in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    # -- error / fault plumbing ----------------------------------------------

    def _record_error(self, exc: BaseException, sink: Optional[Any], *,
                      site: str = "sched.item",
                      worker: Optional[int] = None,
                      lo: int = -1, hi: int = -1,
                      token: Optional[CancelToken] = None):
        """One raising item/task: collect it into the joining waitable
        (``sink.record_error``) so the finish rethrows it, count it in
        telemetry (with the per-site breakdown and the first traceback),
        emit the matching ``sched.error`` instant, and — fail_fast —
        trip the scope's cancel token."""
        tb = traceback.format_exc()
        if sink is not None:
            sink.record_error(TaskError(exc=exc, site=site, worker=worker,
                                        lo=lo, hi=hi, tb=tb))
        self.telemetry.record_error(site, tb)
        obs.instant("sched", "error", args={"site": site})
        if token is not None:
            token.cancel()

    def _on_death(self):
        """A worker thread was told to die (fault injection): the pool
        shrinks permanently — idle accounting loses the seat, telemetry
        counts the death.  The shared FIFO queue means no work is lost:
        peers drain whatever the dead worker would have run."""
        with self._idle_lock:
            self._idle -= 1
        with self.telemetry.lock:
            self.telemetry.worker_deaths += 1
        obs.instant("sched", "worker_death")

    # -- worker loop ---------------------------------------------------------

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            plan = faults.active()
            if plan is not None and plan.should_die("sched.worker"):
                self._q.put(item)  # re-queue: the claimed task is not lost
                self._on_death()
                return
            # legacy producers (tests, external pokes) enqueue (fn, done);
            # _submit adds the scope's cancel token as a third element
            fn, done, *rest = item
            token = rest[0] if rest else None
            outcome = "complete"
            with self._idle_lock:
                self._idle -= 1
            try:
                with obs.trace_span("worker", "task"):
                    fn()
            except TaskCancelled:
                # the chunk observed its scope's token and stopped early
                # (item accounting happened at the observation site)
                outcome = "cancel"
            except Exception as e:
                # Contain task exceptions: the worker thread survives, the
                # done event still fires, so joins (and FinishScope) never
                # hang on a raising task — and the error is COLLECTED into
                # the task's event, so the join rethrows it (X10 finish
                # semantics), never swallows it.
                self._record_error(e, done, site="sched.task", token=token)
            finally:
                with self._idle_lock:
                    self._idle += 1
                with self.telemetry.lock:
                    if outcome == "cancel":
                        self.telemetry.cancelled += 1
                    else:
                        self.telemetry.completions += 1
                obs.instant("sched", outcome)
                done.set()

    def _submit(self, fn: Callable[[], None],
                token: Optional[CancelToken] = None,
                ev: Optional[TaskEvent] = None) -> TaskEvent:
        ev = ev if ev is not None else TaskEvent()
        with self.telemetry.lock:
            self.telemetry.spawns += 1
        obs.instant("sched", "spawn")
        self._q.put((fn, ev, token))
        return ev

    def submit(self, fn: Callable[[], None]) -> TaskEvent:
        """Public single-task entry point (dispatches through the
        subclass's ``_submit``); same spawn accounting as ``run_loop``."""
        return self._submit(fn)

    def idle_workers(self) -> int:
        return self._idle  # intentionally unlocked read

    def shutdown(self):
        for _ in self._threads:
            self._q.put(None)

    def finish(self, fail_mode: str = "run_to_completion") -> FinishScope:
        """Open a DCAFE finish scope for escaped joins.  ``fail_mode``
        picks the exception semantics: aggregate everything at the join
        (default) or cancel sibling chunks on first failure."""
        return FinishScope(self.telemetry, fail_mode=fail_mode)

    # -- grain: how a planned chunk becomes spawned tasks --------------------

    def _grain_plan(self, n: int, policy: SchedPolicy) -> GrainPlan:
        """An explicit ``chunk_grain`` wins; the FIFO pool otherwise keeps
        one task per planned chunk (nothing to steal from a shared queue,
        so pre-splitting only adds overhead)."""
        return GrainPlan(initial=self.chunk_grain)

    def _spawn_range(self, items: Sequence, fn: Callable, lo: int, hi: int,
                     grain: GrainPlan,
                     token: Optional[CancelToken] = None) -> List[Any]:
        """Spawn ``[lo, hi)`` as tasks of at most ``grain.initial`` items;
        returns the waitables the join (or finish scope) collects.  A
        raising item is recorded into its task's event (the join
        rethrows it); the rest of the chunk still runs unless ``token``
        trips, in which case the remaining items are skipped and counted
        cancelled."""
        t = self.telemetry
        step = grain.initial or (hi - lo)
        events = []
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            ev = TaskEvent()

            def task(a=a, b=b, ev=ev):
                plan = faults.active()
                for j in range(a, b):
                    if token is not None and token.cancelled():
                        t.record_cancelled(items=b - j)
                        raise TaskCancelled()
                    t0 = time.perf_counter()
                    try:
                        if plan is not None:
                            plan.poke("sched.item")
                        fn(items[j])
                    except Exception as e:
                        self._record_error(e, ev, site="sched.item",
                                           lo=j, hi=j + 1, token=token)
                    finally:
                        t.record_latency(time.perf_counter() - t0)

            events.append(self._submit(task, token=token, ev=ev))
        return events

    def _join(self, events: Sequence[Any]) -> None:
        """Wait for every spawned task of one loop (the per-loop join)."""
        for ev in events:
            ev.wait()

    # -- policy-driven loop execution ----------------------------------------

    def run_loop(self, items: Sequence, fn: Callable,
                 policy: Union[str, SchedPolicy, None] = None,
                 scope: Optional[FinishScope] = None) -> None:
        """Timed entry point — see :meth:`_run_loop` for the policy
        semantics.  The always-on metrics plane records one bump set
        per loop (count, item volume, wall time), never per item."""
        _MX_LOOPS.inc()
        _MX_ITEMS.inc(len(items))
        mt0 = time.perf_counter()
        try:
            self._run_loop(items, fn, policy, scope)
        finally:
            _MX_LOOP_S.observe(time.perf_counter() - mt0)

    def _run_loop(self, items: Sequence, fn: Callable,
                  policy: Union[str, SchedPolicy, None] = None,
                  scope: Optional[FinishScope] = None) -> None:
        """Execute ``fn(item)`` for every item under the given policy.

        This is the paper's three-block loop: the policy's ``decide``
        picks the parallel arm (spawn the planned chunks, run the caller
        chunk here, join — or escape the join into ``scope`` for DCAFE)
        or the serial arm (one item at a time, re-probing capacity).

        Exception contract (the paper's exception extension): every
        SPAWNED item is attempted — an item whose ``fn`` raises is
        counted in ``telemetry.errors``, COLLECTED into its task's
        waitable, and the rest of its chunk still runs (without per-item
        containment a raise would silently drop the chunk's remaining
        items); the per-loop join then rethrows everything as one
        :class:`MultipleExceptions`, or — DCAFE — the failures travel
        with the escaped join and surface at ``scope.join()``.  A
        ``fail_fast`` scope's :class:`CancelToken` makes sibling chunks
        (and the caller/serial arms) skip their remaining items instead,
        counted in ``cancelled_items``.  Items executed on the CALLING
        thread (the caller's chunk, the serial block) propagate like a
        plain ``for`` loop.
        """
        if policy is None or isinstance(policy, str):
            key = policy or "dlbc"
            cached = self._policy_cache.get(key)
            if cached is None:
                cached = self._policy_cache[key] = get_policy(key)
            policy = cached
        else:
            policy = get_policy(policy)
        t = self.telemetry
        token = scope.token if scope is not None else None
        n = len(items)
        i = 0

        def run_item(j: int, serial: bool):
            t0 = time.perf_counter()
            fn(items[j])
            t.record_latency(time.perf_counter() - t0)
            with t.lock:
                if serial:
                    t.serial_items += 1
                else:
                    t.parallel_items += 1

        while i < n:
            decision = policy.decide(i, n, self.capacity)
            if decision.plan is not None:
                plan = decision.plan
                grain = self._grain_plan(n - i, policy)
                events = []
                for lo, hi in plan.spawned:
                    events.extend(self._spawn_range(items, fn, lo, hi,
                                                    grain, token=token))
                    with t.lock:
                        t.parallel_items += hi - lo
                # parent block: the caller's (smallest) chunk.  Caller
                # items propagate like a plain for loop (see docstring),
                # so the per-item telemetry is batched outside the lock.
                ca, cb = plan.caller
                if cb > ca:
                    ran = 0
                    with obs.trace_span("worker", "caller"):
                        for j in range(ca, cb):
                            if token is not None and token.cancelled():
                                t.record_cancelled(items=cb - j)
                                break
                            t0 = time.perf_counter()
                            fn(items[j])
                            t.record_latency(time.perf_counter() - t0)
                            ran += 1
                    with t.lock:
                        t.parallel_items += ran
                if policy.escape_join and scope is not None:
                    scope.add(events)  # DCAFE: join escapes to the scope
                else:
                    with obs.trace_span("sched", "join_stall"):
                        self._join(events)
                    with t.lock:
                        t.joins += 1
                    obs.instant("sched", "join")
                    errors, total = _collect_errors(events)
                    if total:  # the per-loop finish rethrows (X10)
                        obs_monitor.on_join_failed(self, total,
                                                   site="sched.loop")
                        raise MultipleExceptions(errors, total)
                return
            # serial block with periodic capacity re-probe (cadence counts
            # items processed in THIS block, not the absolute index)
            resumed = False
            every = decision.recheck_every
            done_in_block = 0
            with obs.trace_span("worker", "serial"):
                while i < n:
                    if token is not None and token.cancelled():
                        t.record_cancelled(items=n - i)
                        return
                    run_item(i, serial=True)
                    i += 1
                    done_in_block += 1
                    if (every > 0 and (done_in_block % every == 0)
                            and self.capacity.idle() > 0 and (n - i) >= 2):
                        resumed = True
                        break
            if not resumed:
                return


#: Failed steal scans before a worker parks.  The backoff is a
#: ``sched_yield`` (``time.sleep(0)``): microseconds, not the old 0.1 s
#: global-lock poll, so a worker re-probes a few times while work is
#: still being submitted and only then pays for a real park.
_SPIN_TRIES = 4
#: Parked-worker wait backstop, seconds.  The wakeup protocol (register →
#: re-check → wait; producers push *then* unpark) makes a lost wakeup
#: impossible, so this only bounds the damage of a protocol bug.
_PARK_TIMEOUT = 0.1
#: How long a joining caller waits before it starts helping (claiming
#: items itself).  0 = help immediately: on loops too small to cover the
#: workers' wakeup latency the caller drains stragglers' ranges itself,
#: degrading gracefully toward serial speed instead of sleeping.
_HELP_GRACE = 0.0
#: Items a helper claims per lock acquisition when recent item costs
#: look uniform (batch amortisation); skewed costs force batch = 1.
_HELP_BATCH = 8


class WorkStealingExecutor(ThreadExecutor):
    """Per-worker deques, per-deque locks, lazy steal-driven splitting.

    Tasks carry ``(lo, hi)`` ranges (:class:`RangeTask`) instead of
    single items.  The **owner** claims items off the front of its front
    task one at a time (one uncontended lock acquisition per item — no
    queue round-trip, no per-item event).  A **thief** with an empty
    deque scans victims from a randomised start, picks the largest range
    with at least ``split_min`` items left, and steals its *back half*
    by truncating ``hi`` — the stolen half lands on the thief's own
    deque, where it is itself stealable, so the split recurses and grain
    adapts to observed imbalance with zero tuning.  When only
    single-item tasks remain, the back task is stolen whole (classic
    Arora–Blumofe–Plotkin).

    Synchronisation: one lock per deque (owner claim and thief split of
    the same range serialise on the *victim's* lock; disjoint deques
    never contend) plus a parked-worker protocol — an out-of-work worker
    backs off briefly, registers itself parked, re-checks every deque,
    and sleeps on its own event until a producer pushes work — replacing
    the old single global condition variable and its 0.1 s poll.  Joins:
    every submitted range gets ONE :class:`RangeLatch` shared by all its
    splits, so a DCAFE :class:`FinishScope` holds O(ranges) waitables,
    not O(items).

    Counter contract (all bumps under ``telemetry.lock``): ``spawns``
    counts task creations (submits + splits), ``completions`` counts
    tasks drained to exhaustion, ``cancelled`` counts tasks whose
    remainder was skipped by a fail_fast token — ``spawns ==
    completions + cancelled`` at quiescence; ``steals`` counts
    successful steals (``splits`` of them split a range;
    ``steal_victims`` histograms who they hit).
    """

    #: ``None`` = adaptive: ranges are carved per the policy's
    #: ``grain_plan`` (ceil(n / (k·workers)) items each) and re-split on
    #: steal.  Set an int (e.g. 1) to force a fixed grain — the
    #: benchmark baselines do.
    chunk_grain: Optional[int] = None

    def __init__(self, n_workers: int = 4,
                 telemetry: Optional[SchedTelemetry] = None):
        self._locks = [threading.Lock() for _ in range(n_workers)]
        self._deques: List[deque] = [deque() for _ in range(n_workers)]
        self._stop = False
        self._rr = count()
        self._park_lock = threading.Lock()
        self._park_events = [threading.Event() for _ in range(n_workers)]
        self._parked: set = set()
        #: workers that died (fault injection).  A worker adds itself
        #: under its OWN deque lock before sweeping orphans, and
        #: placement checks membership under that same lock — so a task
        #: either lands before the sweep (and is swept to a live deque)
        #: or sees the death and picks another victim.  Never stranded.
        self._dead: set = set()
        super().__init__(n_workers, telemetry)

    # -- submission ----------------------------------------------------------

    def _place_on(self, task: RangeTask) -> int:
        """Round-robin the task onto a LIVE worker's deque (no wakeup —
        the caller batches unparks); returns the chosen worker."""
        for _ in range(2 * self.n_workers):
            v = next(self._rr) % self.n_workers
            with self._locks[v]:
                if v in self._dead:
                    continue
                self._deques[v].append(task)
                return v
        raise RuntimeError("no live workers left to place work on")

    def _place(self, task: RangeTask):
        """Place a task and wake someone — preferably that deque's
        owner, so work does not sit in a parked worker's deque until
        another worker happens to scan it."""
        v = self._place_on(task)
        self._unpark(prefer=v)

    def _submit(self, fn: Callable[[], None],
                token: Optional[CancelToken] = None,
                ev: Optional[TaskEvent] = None) -> RangeLatch:
        """Single-callable entry point (``submit``/base helpers): a
        one-item range.  (``ev`` is the FIFO pool's premade-event hook;
        ranges collect errors in their latch instead, so it is unused.)"""
        latch = RangeLatch(1)
        with self.telemetry.lock:
            self.telemetry.spawns += 1
        obs.instant("sched", "spawn")
        self._place(RangeTask(None, fn, 0, 1, latch, token=token))
        return latch

    def _grain_plan(self, n: int, policy: SchedPolicy) -> GrainPlan:
        if self.chunk_grain:
            return GrainPlan(initial=self.chunk_grain)
        return policy.grain_plan(n, self.capacity, self.telemetry)

    def _spawn_range(self, items, fn, lo, hi, grain: GrainPlan,
                     token: Optional[CancelToken] = None):
        """Carve ``[lo, hi)`` into initial ranges and place them in one
        wave: one spawn-counter bump, one deque push per range, then one
        unpark sweep — the submit path is O(ranges), not O(items)."""
        step = grain.initial or (hi - lo)
        tasks = []
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            tasks.append(RangeTask(items, fn, a, b, RangeLatch(b - a),
                                   grain.split_min, token=token))
        with self.telemetry.lock:
            self.telemetry.spawns += len(tasks)
        obs.instant("sched", "spawn", n=len(tasks))
        owners = set()
        for task in tasks:
            owners.add(self._place_on(task))
        for v in owners:
            self._unpark(prefer=v)
        return [task.latch for task in tasks]

    # -- worker loop ---------------------------------------------------------

    def _on_death(self, w: int):
        """This worker dies (fault injection): mark the deque dead under
        its own lock (closing the placement race — see ``_dead``), sweep
        any queued tasks to live deques, release the idle seat, and wake
        everyone so the swept work is picked up."""
        lock, dq = self._locks[w], self._deques[w]
        with lock:
            self._dead.add(w)
            orphans = list(dq)
            dq.clear()
        with self._idle_lock:
            self._idle -= 1
        with self.telemetry.lock:
            self.telemetry.worker_deaths += 1
        obs.instant("sched", "worker_death")
        for task in orphans:
            self._place_on(task)
        self._unpark(all_workers=True)

    def _worker(self):
        w = self._threads.index(threading.current_thread())
        rng = random.Random(0x5EED ^ (w * 0x9E3779B9))
        attempts = 0
        while True:
            plan = faults.active()
            if plan is not None and plan.should_die("sched.worker"):
                self._on_death(w)
                return
            if self._drain_own(w):
                attempts = 0
                continue
            if self._try_steal(w, rng):
                attempts = 0
                continue
            if self._stop:
                # Drain semantics matching ThreadExecutor's sentinel
                # queue: exit only once no work is visible anywhere, so
                # already-submitted tasks still run and their latches
                # fire (a FinishScope.join never hangs).
                return
            attempts += 1
            if attempts <= _SPIN_TRIES:
                time.sleep(0)  # sched_yield: bounded, near-free backoff
            else:
                self._park(w)

    def _drain_own(self, w: int) -> bool:
        """Run every task on our own deque to exhaustion.  Returns True
        if any work was found (the caller then re-scans immediately)."""
        lock, dq = self._locks[w], self._deques[w]
        if not dq:  # racy peek: cheap fast path past empty deques
            return False
        with self._idle_lock:
            self._idle -= 1
        worked = False
        try:
            while True:
                with lock:
                    if not dq:
                        return worked
                    task = dq[0]
                    task.active = True  # helpers now leave the pop to us
                worked = True
                self._drain_task(w, task)
        finally:
            with self._idle_lock:
                self._idle += 1

    def _drain_task(self, w: int, task: RangeTask):
        """One drain session: claim items off the front of ``task`` (our
        deque's front, which only we ever pop) until it is exhausted —
        naturally, by thieves truncating ``hi``, or by its scope's
        cancel token tripping (the remainder is skipped and counted
        cancelled) — then pop it and credit its latch once with
        everything we ran or skipped."""
        lock, dq = self._locks[w], self._deques[w]
        token = task.token
        ran = 0
        skipped = 0
        try:
            with obs.trace_span("worker", "drain"):
                while True:
                    with lock:
                        if (token is not None and token.cancelled()
                                and task.lo < task.hi):
                            skipped = task.hi - task.lo
                            task.lo = task.hi
                        if task.lo >= task.hi:
                            dq.popleft()  # ours: helpers skip active
                            return        # tasks' last items, thieves
                            #               never pop front
                        j = task.lo
                        task.lo = j + 1
                    self._run_item(task, j, w)
                    ran += 1
        finally:
            # completions before the latch: a joiner woken by the final
            # discharge must already observe spawns == completions +
            # cancelled
            with self.telemetry.lock:
                if skipped:
                    self.telemetry.cancelled += 1
                    self.telemetry.cancelled_items += skipped
                else:
                    self.telemetry.completions += 1
            obs.instant("sched", "cancel" if skipped else "complete")
            task.latch.discharge(ran + skipped)

    def _run_item(self, task: RangeTask, j: int, w: Optional[int] = None):
        t = self.telemetry
        t0 = time.perf_counter()
        try:
            if task.items is not None:
                plan = faults.active()
                if plan is not None:
                    plan.poke("sched.item")
            task.run(j)
        except Exception as e:
            # same containment contract as ThreadExecutor._worker: the
            # worker survives, the claimed item still counts, the latch
            # still fires — and carries the error to the join, wherever
            # the item ran (owner, thief, or helper)
            self._record_error(e, task.latch, site="sched.item",
                               worker=w, lo=j, hi=j + 1, token=task.token)
        finally:
            t.record_latency(time.perf_counter() - t0)

    # -- helping join --------------------------------------------------------

    def _join(self, events: Sequence[Any]) -> None:
        """Join by *helping*: the caller claims items off the largest
        visible range until every latch fires.  This is what ranges buy
        over per-item tasks — a joiner can contribute to exactly the
        range that is behind, so a heavy head never strands on one worker
        while the caller sleeps, and a loop too small to cover the
        workers' wakeup latency degrades gracefully toward serial speed
        (the helper takes over owner-less tasks entirely, see
        :meth:`_help_one`).  An optional grace period (``_HELP_GRACE``)
        can keep the caller off the deque locks on loops expected to
        join immediately."""
        pending = [ev for ev in events if not ev.is_set()]
        if not pending:
            return
        if _HELP_GRACE > 0:
            deadline = time.perf_counter() + _HELP_GRACE
            for ev in pending:
                left = deadline - time.perf_counter()
                if left <= 0 or not ev.wait(timeout=left):
                    break
            pending = [ev for ev in pending if not ev.is_set()]
        # Helper claim granularity from the same feedback signal the
        # grain controller uses: uniform recent item costs → batch claims
        # (amortise the lock over several items); skewed costs → one item
        # at a time, so the helper never walks off with a heavy head.
        batch = _HELP_BATCH if self.telemetry.recent_skew() < 2.0 else 1
        idle_rounds = 0
        while pending:
            if self._help_one(batch):
                idle_rounds = 0
            elif idle_rounds < _SPIN_TRIES:
                # nothing claimable but latches unset: the owners hold
                # only their final items — yield them the core instead
                # of oversleeping a futex quantum
                idle_rounds += 1
                time.sleep(0)
            else:
                pending[0].wait(timeout=5e-4)
            pending = [ev for ev in pending if not ev.is_set()]

    def _help_one(self, batch: int = 1) -> bool:
        """Claim and run up to ``batch`` items from the largest helpable
        range.  Find and claim happen under one hold of that deque's
        lock — a task's range is only ever mutated under the lock of the
        deque currently holding it.  An *active* task (an owner session
        holds it) is helpable down to its last item, which stays with
        the owner; an *inactive* task (its owner is parked or busy
        elsewhere) can be taken over entirely — claiming its last item
        removes it, so a join never stalls on a wakeup for microseconds
        of work."""
        for v in range(self.n_workers):
            if not self._deques[v]:  # racy peek
                continue
            lock, dq = self._locks[v], self._deques[v]
            cancel_claim = None
            with lock:
                best, best_sz = None, 0
                for task in dq:
                    tok = task.token
                    if (tok is not None and tok.cancelled()
                            and task.hi > task.lo):
                        # fail_fast: consume the whole remainder as
                        # cancelled so a join never stalls on work
                        # nobody should run (a parked owner's inactive
                        # cancelled task would otherwise sit forever)
                        skipped = task.hi - task.lo
                        task.lo = task.hi
                        removed = not task.active
                        if removed:
                            dq.remove(task)
                        cancel_claim = (task, skipped, removed)
                        break
                    sz = task.hi - task.lo
                    if sz > best_sz and (sz >= 2 or not task.active):
                        best, best_sz = task, sz
                if cancel_claim is None and best is None:
                    continue
                if cancel_claim is None:
                    take = min(batch,
                               best_sz - 1 if best.active else best_sz)
                    j = best.lo
                    best.lo = j + take
                    removed = best.lo >= best.hi and not best.active
                    if removed:
                        dq.remove(best)
            if cancel_claim is not None:
                task, skipped, removed = cancel_claim
                with self.telemetry.lock:
                    self.telemetry.cancelled_items += skipped
                    if removed:
                        # the task dies here; an active task's owner
                        # session still counts it (as a completion of
                        # its emptied range)
                        self.telemetry.cancelled += 1
                if removed:
                    obs.instant("sched", "cancel")
                task.latch.discharge(skipped)
                return True
            for jj in range(j, j + take):
                self._run_item(best, jj)
            if removed:
                with self.telemetry.lock:
                    self.telemetry.completions += 1
                obs.instant("sched", "complete")
            best.latch.discharge(take)
            return True
        return False

    # -- stealing ------------------------------------------------------------

    def _try_steal(self, w: int, rng: random.Random) -> bool:
        """Scan victims from a randomised start (no worker-0 hotspot) and
        take the first steal that lands; the loot goes to the front of
        our own deque, where it is immediately drainable — and itself
        stealable, so splitting recurses."""
        n = self.n_workers
        # clock read only when tracing: steal latency = scan start →
        # loot landed; failed scans (idle spinning) emit nothing
        t0 = obs.perf_counter_ns() if obs.enabled() else 0
        start = rng.randrange(n)
        for d in range(n):
            v = (start + d) % n
            if v == w:
                continue
            loot = self._steal_from(v)
            if loot is None:
                continue
            task, split = loot
            with self._locks[w]:
                self._deques[w].appendleft(task)
            t = self.telemetry
            with t.lock:
                t.steals += 1
                t.steal_victims[v] = t.steal_victims.get(v, 0) + 1
                if split:
                    t.splits += 1
                    t.spawns += 1  # a split mints a new task
            if obs.enabled():
                obs.complete_span("sched", "steal", t0, {"victim": v})
                obs.instant("sched", "steal", args={"victim": v})
                if split:
                    obs.instant("sched", "split")
                    obs.instant("sched", "spawn")  # the minted task
            return True
        return False

    def _steal_from(self, v: int) -> Optional[Tuple[RangeTask, bool]]:
        """Under the victim's deque lock: split the largest splittable
        range (steal its back half), else pop a whole queued task off the
        back.  The front task is never popped by a thief — its owner may
        be mid-claim — but it *is* splittable, because a split only
        truncates ``hi`` above the owner's claim cursor."""
        lock, dq = self._locks[v], self._deques[v]
        if not dq:  # racy peek, see _drain_own
            return None
        with lock:
            if not dq:
                return None
            best = None
            for task in dq:
                size = task.hi - task.lo
                if size >= task.split_min and (
                        best is None or size > best.hi - best.lo):
                    best = task
            if best is not None:
                # back half to the thief, the odd item stays with the
                # owner (who is already consuming lo forward)
                mid = best.lo + (best.hi - best.lo + 1) // 2
                stolen = RangeTask(best.items, best.fn, mid, best.hi,
                                   best.latch, best.split_min,
                                   token=best.token)
                best.hi = mid
                return stolen, True
            if len(dq) >= 2:
                return dq.pop(), False
            return None

    # -- parking -------------------------------------------------------------

    def _unpark(self, prefer: Optional[int] = None, all_workers: bool = False):
        with self._park_lock:
            if all_workers:
                woken, self._parked = set(self._parked), set()
            elif prefer is not None and prefer in self._parked:
                self._parked.discard(prefer)
                woken = {prefer}
            elif self._parked:
                woken = {self._parked.pop()}
            else:
                return
        for v in woken:
            self._park_events[v].set()

    def _park(self, w: int):
        """Register parked, re-check for work, then sleep until a
        producer's unpark (or the backstop timeout).  The register-then-
        re-check order pairs with the producers' push-then-unpark order:
        any push racing our scan either lands before the scan reads that
        deque (we see it) or unparks us afterwards (we are registered)."""
        ev = self._park_events[w]
        with self._park_lock:
            ev.clear()
            self._parked.add(w)
        # Re-check only our own deque: cross-deque work is covered by the
        # producers' push-then-unpark order, and re-checking every deque
        # here would busy-spin whenever the only remaining work is an
        # unstealable front task some owner is already draining.
        if self._stop or self._deques[w]:
            with self._park_lock:
                self._parked.discard(w)
            return
        with obs.trace_span("sched", "park"):
            ev.wait(timeout=_PARK_TIMEOUT)
        with self._park_lock:
            self._parked.discard(w)

    def shutdown(self):
        self._stop = True
        self._unpark(all_workers=True)


class SlotExecutor:
    """Admission scheduling over fixed device slots (continuous batching).

    A queued request is one task; an idle slot is an idle worker.  The
    policy's ``admit`` applies the paper's spawn rule: DLBC admits into
    every idle slot at every decode step (per-iteration re-check), LC
    waits for a full batch of free slots (static chunking of requests).
    Refills are FIFO with oldest request → lowest slot index — the
    remainder-spread priority of Fig. 6.

    ``refill`` accepts either a plain FIFO list (the single-queue serving
    path, unchanged) or a :class:`~repro.sched.tenancy.TenantRegistry`:
    the policy still decides *how many* requests the idle slots admit,
    and the weighted deficit-round-robin decides *which tenant* each
    admission comes from.  The executor keeps per-tenant occupancy
    (``slot_tenant``) so slot-share accounting and the per-tenant
    spawn/join telemetry stay with the one object that owns the slots.
    """

    def __init__(self, n_slots: int,
                 policy: Union[str, SchedPolicy, None] = "dlbc",
                 telemetry: Optional[SchedTelemetry] = None):
        self.n_slots = n_slots
        self.policy = get_policy(policy)
        self.telemetry = telemetry or SchedTelemetry()
        #: which tenant occupies each slot (None = idle / anonymous)
        self.slot_tenant: List[Optional[str]] = [None] * n_slots
        self._weighted: Optional[Any] = None  # lazily wrapped policy

    def _admit_count(self, n_idle: int, n_queued: int) -> int:
        # clamp: a custom policy may over-admit; never index past the idle
        # slots or pop an empty queue
        return min(self.policy.admit(n_idle, n_queued, self.n_slots),
                   n_idle, n_queued)

    def refill(self, slots: Sequence[Optional[Any]],
               queue: Union[List, TenantRegistry]) -> List[Tuple[int, Any]]:
        """Pop up to ``policy.admit(...)`` requests and pair them with idle
        slots (oldest request → lowest slot).  Mutates ``queue``."""
        if isinstance(queue, TenantRegistry):
            return self.refill_tenants(slots, queue)
        cap = SlotCapacity(list(slots))
        idle = cap.idle_indices()
        k = self._admit_count(len(idle), len(queue))
        placements = [(idle[j], queue.pop(0)) for j in range(k)]
        with self.telemetry.lock:
            self.telemetry.spawns += len(placements)
        if placements:
            obs.instant("sched", "spawn", n=len(placements))
            obs.instant("serve", "admit", n=len(placements))
        return placements

    def weighted_policy(self):
        """Resolve (and cache) the cross-tenant refill policy.  Raises
        for escape-join bases (DCAFE) — call at configuration time to
        fail fast rather than on the first mid-run refill."""
        if self._weighted is None:
            self._weighted = ensure_weighted(self.policy)
        return self._weighted

    def refill_tenants(self, slots: Sequence[Optional[Any]],
                       registry: TenantRegistry) -> List[Tuple[int, Any]]:
        """Tenant-aware refill: the base policy's idle-slot arithmetic
        sizes the admission, the deficit round-robin picks the tenants.
        Returns ``(slot, request)`` pairs; ``slot_tenant`` and the
        per-tenant spawn counters record who got each slot."""
        pol = self.weighted_policy()
        cap = SlotCapacity(list(slots))
        idle = cap.idle_indices()
        k = self._admit_count(len(idle), registry.total_queued())
        placements: List[Tuple[int, Any]] = []
        for j, (tenant, req) in enumerate(pol.pick(registry, k)):
            slot = idle[j]
            self.slot_tenant[slot] = tenant.name
            self.telemetry.tenant(tenant.name).spawns += 1
            placements.append((slot, req))
        with self.telemetry.lock:
            self.telemetry.spawns += len(placements)
        if placements:
            obs.instant("sched", "spawn", n=len(placements))
            obs.instant("serve", "admit", n=len(placements))
        return placements

    def prefill(self, slot: int, ntokens: int):
        """One prefill chunk of ``ntokens`` prompt tokens executed
        in-place in ``slot`` (DLBC worksharing: the chunk runs on the
        slot that owns the request, no task is created for it).

        Counted in the dedicated ``prefill_chunks``/``prefill_tokens``
        counters — deliberately NOT in spawns/joins: the serving AFE
        contract is one FinishScope join per REQUEST, and chunk
        accounting must never disturb the ``spawns == joins``
        quiescence invariant the CI gates replay.  Emits a
        ``serve.prefill_chunk`` instant so the trace shows every chunk
        without inflating the conservation-gated spawn/join events."""
        with self.telemetry.lock:
            self.telemetry.prefill_chunks += 1
            self.telemetry.prefill_tokens += int(ntokens)
        name = self.slot_tenant[slot]
        if name is not None:
            bucket = self.telemetry.tenant(name)
            bucket.prefill_chunks += 1
            bucket.prefill_tokens += int(ntokens)
        obs.instant("serve", "prefill_chunk", n=int(ntokens))

    def tenant_busy_slots(self) -> Dict[str, int]:
        """Occupied-slot count per tenant right now (slot-share
        accounting: the serving stats integrate this every step)."""
        out: Dict[str, int] = {}
        for name in self.slot_tenant:
            if name is not None:
                out[name] = out.get(name, 0) + 1
        return out

    def complete(self, latency_steps: Optional[float] = None,
                 slot: Optional[int] = None):
        """A sequence finished: count the join (finish analogue); with a
        ``slot`` the tenant occupancy is released and the join lands on
        that tenant's counters too."""
        with self.telemetry.lock:
            self.telemetry.joins += 1
        obs.instant("sched", "join")
        if slot is not None:
            name = self.slot_tenant[slot]
            if name is not None:
                self.telemetry.tenant(name).joins += 1
            self.slot_tenant[slot] = None
        if latency_steps is not None:
            self.telemetry.record_latency(latency_steps)
