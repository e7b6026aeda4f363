"""Deterministic multi-worker runtime simulator for the async-finish IR.

Models the X10 runtime (XRX) the paper targets:

* a pool of W workers (``X10_NTHREADS``) executing tasks non-preemptively;
* spawned tasks enter a FIFO pool; idle workers take the oldest task;
* an activity blocked at a ``finish`` join releases its worker (XRX
  work-stealing semantics — required for recursive programs to make
  progress at all), configurable via ``CostModel.blocked_worker_helps``;
* ``Runtime.retIdleWorkers()`` reads the scheduler's idle-worker count at
  the current simulated instant *without atomics* — two tasks sampling at
  the same instant may observe the same count, exactly the benign race the
  paper describes (§3.2.1);
* clocks: spawned ``async clocked(c)`` tasks register on ``c``;
  ``Clock.advanceAll()`` blocks until every registered task arrives; task
  termination deregisters.  A task blocking at a finish join is
  auto-deregistered from its clocks (X10 forbids joining while registered —
  ClockUseException — the paper's generated code never does; deregistering
  keeps the simulator deadlock-free, documented in DESIGN.md);
* dynamic counters for task creation (``async``) and termination
  (``finish``) operations — the paper's Fig. 10 metrics — plus a simulated
  makespan and an energy proxy (busy/idle power model + per-op energy, the
  Fig. 13 analogue).

Event ordering is a (time, seq) heap → fully deterministic.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .errors import ExcValue, SimException, make_me
from .ir import (
    Assign, Async, Barrier, Break, Call, Compute, Continue, Expr, Finish,
    ForLoop, If, MethodDef, NewClock, Program, Seq, Skip, Stmt, Throw,
    TryCatch, While,
)
from ..sched.capacity import SimWorkerCapacity
from ..sched.telemetry import SchedCounters

# ---------------------------------------------------------------------------
# Cost / power model
# ---------------------------------------------------------------------------


@dataclass
class CostModel:
    async_spawn: float = 1.0      # task-creation overhead (the paper's target)
    finish_op: float = 1.0        # join bookkeeping (collect exceptions, dealloc)
    barrier_op: float = 0.5
    dispatch: float = 0.25        # ready task → running on an idle worker
    stmt_overhead: float = 0.02   # interpreted statement (chunk math, checks)
    blocked_worker_helps: bool = True
    power_busy: float = 1.0
    power_idle: float = 0.3
    energy_per_async: float = 0.5
    energy_per_finish: float = 0.5


class Counters(SchedCounters):
    """Fig. 10 counter names over the shared scheduling counters
    (:class:`repro.sched.telemetry.SchedCounters`): ``asyncs`` ≡ spawns,
    ``finishes`` ≡ joins — one vocabulary across the simulator, the host
    pools, and the serving batcher."""

    @property
    def asyncs(self) -> int:
        return self.spawns

    @asyncs.setter
    def asyncs(self, v: int):
        self.spawns = v

    @property
    def finishes(self) -> int:
        return self.joins

    @finishes.setter
    def finishes(self, v: int):
        self.joins = v

    def as_dict(self):
        return dict(asyncs=self.asyncs, finishes=self.finishes,
                    barriers=self.barriers, steps=self.steps, work=self.work)


# ---------------------------------------------------------------------------
# Runtime objects
# ---------------------------------------------------------------------------


class BreakSignal(Exception):
    pass


class ContinueSignal(Exception):
    pass


class FinishFrame:
    __slots__ = ("active", "collected", "waiter", "closed")

    def __init__(self):
        self.active = 0
        self.collected: List[ExcValue] = []
        self.waiter: Optional["Task"] = None
        self.closed = False


class ClockObj:
    _ids = itertools.count()

    def __init__(self):
        self.id = next(ClockObj._ids)
        self.registered: set = set()
        self.arrived: set = set()
        self.phase = 0

    def __repr__(self):  # pragma: no cover
        return f"Clock#{self.id}(reg={len(self.registered)}, arr={len(self.arrived)})"


class Task:
    _ids = itertools.count()

    def __init__(self, gen, ief: Optional[FinishFrame], clocks=()):
        self.id = next(Task._ids)
        self.gen = gen
        self.ief = ief
        self.finish_stack: List[FinishFrame] = []
        self.clocks: List[ClockObj] = list(clocks)
        self.local_time = 0.0
        self.worker: Optional[int] = None
        self.blocked_on: Any = None
        self.done = False

    def current_frame(self) -> Optional[FinishFrame]:
        return self.finish_stack[-1] if self.finish_stack else self.ief


class EnvView:
    """Locals → heap name resolution + scheduler hooks for intrinsics."""

    __slots__ = ("locals", "heap", "sched")

    def __init__(self, locals_: dict, heap: dict, sched: "Scheduler"):
        self.locals = locals_
        self.heap = heap
        self.sched = sched

    def __getitem__(self, name: str):
        if name in self.locals:
            return self.locals[name]
        return self.heap[name]

    def get(self, name: str, default=None):
        if name in self.locals:
            return self.locals[name]
        return self.heap.get(name, default)

    def __contains__(self, name: str):
        return name in self.locals or name in self.heap

    def set(self, name: str, value, declare_local: bool = False):
        if declare_local or name in self.locals:
            self.locals[name] = value
        elif name in self.heap:
            self.heap[name] = value
        else:
            self.locals[name] = value

    def set_heap(self, name: str, value):
        self.heap[name] = value

    # -- intrinsics ---------------------------------------------------------

    def runtime_idle_workers(self) -> int:
        return self.sched.idle_count()

    def runtime_n_threads(self) -> int:
        return self.sched.n_workers

    def rethrow(self, value):
        if value is None:
            return
        if not isinstance(value, ExcValue):
            value = ExcValue(payload=value)
        raise SimException(value)

    def wrap_me(self, *values):
        return make_me(*values)


# ---------------------------------------------------------------------------
# Interpreter (generator-based)
# ---------------------------------------------------------------------------

WORK = "work"
SPAWN = "spawn"
JOIN = "join"
ADVANCE = "advance"
SYNC = "sync"  # zero-duration heap round-trip (orders intrinsic reads)


class Interp:
    def __init__(self, prog: Program, sched: "Scheduler", cm: CostModel):
        self.prog = prog
        self.sched = sched
        self.cm = cm
        self.methods = {m.name: m for m in prog.methods}

    def task_gen(self, body: Stmt, locals_: dict, task_box: list):
        """Top-level generator for a task; task_box[0] is set to the Task."""
        env = EnvView(locals_, self.sched.heap, self.sched)
        yield from self.exec(body, env, task_box)

    # -- statement execution -------------------------------------------------

    def exec(self, s: Stmt, env: EnvView, tb: list):
        cm = self.cm
        sched = self.sched
        if isinstance(s, Skip):
            return
        sched.counters.steps += 1
        if isinstance(s, Seq):
            for st in s.stmts:
                yield from self.exec(st, env, tb)
            return
        if isinstance(s, Assign):
            if s.value.intrinsic:
                yield (SYNC,)  # order intrinsic reads in global time
            env.set(s.target, s.value.fn(env), declare_local=s.declare_local)
            c = s.cost + cm.stmt_overhead
            if c > 0:
                yield (WORK, c)
            return
        if isinstance(s, Compute):
            cost = s.cost.fn(env) if isinstance(s.cost, Expr) else s.cost
            s.fn(env)
            yield (WORK, float(cost) + cm.stmt_overhead)
            return
        if isinstance(s, Async):
            clock_objs = []
            for cname in s.clocks:
                c = env[cname]
                assert isinstance(c, ClockObj), f"{cname} is not a clock"
                clock_objs.append(c)
            child_locals = dict(env.locals)  # X10 val-capture snapshot
            yield (WORK, cm.async_spawn)
            yield (SPAWN, (s.body, child_locals, clock_objs))
            return
        if isinstance(s, Finish):
            assert not s.exlist, "pending exlist must be lowered before execution"
            task: Task = tb[0]
            frame = FinishFrame()
            task.finish_stack.append(frame)
            sync_exc: Optional[ExcValue] = None
            try:
                yield from self.exec(s.body, env, tb)
            except SimException as ex:
                sync_exc = ex.value
            finally:
                task.finish_stack.pop()
            frame.closed = True
            yield (JOIN, frame)
            yield (WORK, cm.finish_op)
            sched.counters.finishes += 1
            excs = ([sync_exc] if sync_exc is not None else []) + frame.collected
            if excs:
                raise SimException(make_me(*excs))
            return
        if isinstance(s, ForLoop):
            v = s.loopvar
            env.set(v, s.lo.fn(env), declare_local=True)
            while True:
                hi = s.hi.fn(env)
                if not (env[v] < hi):
                    break
                try:
                    yield from self.exec(s.body, env, tb)
                except BreakSignal:
                    break
                except ContinueSignal:
                    pass
                env.set(v, env[v] + s.step.fn(env))
            return
        if isinstance(s, While):
            while True:
                if s.cond.intrinsic:
                    yield (SYNC,)
                if not s.cond.fn(env):
                    break
                try:
                    yield from self.exec(s.body, env, tb)
                except BreakSignal:
                    break
                except ContinueSignal:
                    continue
            return
        if isinstance(s, Break):
            raise BreakSignal()
        if isinstance(s, Continue):
            raise ContinueSignal()
        if isinstance(s, If):
            if s.cond.intrinsic:
                yield (SYNC,)
            if s.cond.fn(env):
                yield from self.exec(s.then, env, tb)
            else:
                yield from self.exec(s.els, env, tb)
            return
        if isinstance(s, Call):
            m = self.methods[s.callee]
            argvals = [a.fn(env) for a in s.args]
            call_env = EnvView(dict(zip(m.params, argvals)), env.heap, self.sched)
            yield (WORK, cm.stmt_overhead)
            yield from self.exec(m.body, call_env, tb)
            return
        if isinstance(s, NewClock):
            c = ClockObj()
            task: Task = tb[0]
            c.registered.add(task)
            task.clocks.append(c)
            env.set(s.target, c, declare_local=True)
            return
        if isinstance(s, Barrier):
            yield (ADVANCE,)
            yield (WORK, cm.barrier_op)
            self.sched.counters.barriers += 1
            return
        if isinstance(s, Throw):
            raise SimException(ExcValue(type_name=s.exc_type, payload=s.payload.fn(env)))
        if isinstance(s, TryCatch):
            try:
                yield from self.exec(s.body, env, tb)
            except SimException as ex:
                if ex.value.matches(s.exc_types):
                    env.set(s.exc_var, ex.value, declare_local=True)
                    yield from self.exec(s.handler, env, tb)
                else:
                    raise
            return
        raise TypeError(f"unknown statement {s!r}")


# ---------------------------------------------------------------------------
# Scheduler (discrete-event, deterministic)
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    time: float
    counters: Counters
    energy: float
    heap: dict
    error: Optional[ExcValue] = None
    worker_busy: tuple = ()

    @property
    def ok(self) -> bool:
        return self.error is None


class Scheduler:
    def __init__(self, prog: Program, n_workers: int, cm: Optional[CostModel] = None,
                 heap: Optional[dict] = None, max_events: int = 50_000_000):
        self.prog = prog
        self.n_workers = n_workers
        self.cm = cm or CostModel()
        self.heap: dict = dict(heap or {})
        self.counters = Counters()
        self.interp = Interp(prog, self, self.cm)
        self.events: list = []  # (time, seq, task)
        self._seq = itertools.count()
        self.idle: set = set(range(n_workers))
        self.capacity = SimWorkerCapacity(self)  # repro.sched view of idleness
        self.pending: List[Task] = []  # FIFO task pool
        self.busy_time = [0.0] * n_workers
        self.now = 0.0
        self.max_events = max_events
        self.root_frame = FinishFrame()
        self.root_error: Optional[ExcValue] = None

    # -- queries --------------------------------------------------------------

    def idle_count(self) -> int:
        # ``Runtime.retIdleWorkers()`` — routed through the shared
        # CapacityProvider so the simulator reads idleness the same way
        # the host pools and the batcher do (benign race preserved).
        return self.capacity.idle()

    # -- scheduling primitives --------------------------------------------------

    def _push(self, t: float, task: Task):
        heapq.heappush(self.events, (t, next(self._seq), task))

    def _make_task(self, body: Stmt, locals_: dict, clocks, ief: Optional[FinishFrame]) -> Task:
        tb: list = [None]
        gen = self.interp.task_gen(body, locals_, tb)
        task = Task(gen, ief, clocks)
        tb[0] = task
        for c in task.clocks:
            c.registered.add(task)
        if ief is not None:
            ief.active += 1
        return task

    def _enqueue_ready(self, task: Task, t: float):
        """Task is runnable; give it a worker or pool it."""
        if self.idle:
            w = min(self.idle)
            self.idle.discard(w)
            task.worker = w
            self._push(t + self.cm.dispatch, task)
        else:
            self.pending.append(task)

    def _release_worker(self, w: int, t: float):
        if self.pending:
            task = self.pending.pop(0)
            task.worker = w
            self._push(t + self.cm.dispatch, task)
        else:
            self.idle.add(w)

    # -- clock machinery ---------------------------------------------------------

    def _clock_try_release(self, c: ClockObj, t: float):
        if c.registered and c.arrived >= c.registered:
            c.phase += 1
            waiters = list(c.arrived)
            c.arrived = set()
            for task in waiters:
                if task.blocked_on == ("clock",) and all(
                    (cc.phase > task._wait_phase[cc.id]) for cc in task.clocks
                ):
                    task.blocked_on = None
                    self._enqueue_ready_resume(task, t)

    def _enqueue_ready_resume(self, task: Task, t: float):
        if task.worker is not None:
            # Worker was held (blocked_worker_helps=False path).
            self._push(t, task)
        else:
            self._enqueue_ready(task, t)

    def _deregister_clocks(self, task: Task, t: float):
        for c in task.clocks:
            c.registered.discard(task)
            c.arrived.discard(task)
            self._clock_try_release(c, t)
        task.clocks = []

    # -- task lifecycle ------------------------------------------------------------

    def _finish_task(self, task: Task, t: float, exc: Optional[ExcValue]):
        task.done = True
        self._deregister_clocks(task, t)
        frame = task.ief
        if exc is not None:
            if frame is not None:
                frame.collected.append(exc)
            else:
                self.root_error = exc
        if frame is not None:
            frame.active -= 1
            if frame.active == 0 and frame.waiter is not None:
                waiter = frame.waiter
                frame.waiter = None
                waiter.blocked_on = None
                self._enqueue_ready_resume(waiter, t)
        if task.worker is not None:
            w = task.worker
            task.worker = None
            self._release_worker(w, t)

    def _block_task(self, task: Task, t: float):
        """Release worker per help-first policy."""
        if self.cm.blocked_worker_helps and task.worker is not None:
            w = task.worker
            task.worker = None
            self._release_worker(w, t)

    # -- main loop -------------------------------------------------------------------

    def run(self, main_args: tuple = ()) -> SimResult:
        main = self.prog.method(self.prog.main)
        locals_ = dict(zip(main.params, main_args))
        root = self._make_task(self.prog.method(self.prog.main).body, locals_, (), self.root_frame)
        self.root_frame.active = 1
        self._enqueue_ready(root, 0.0)

        events_processed = 0
        while self.events:
            events_processed += 1
            if events_processed > self.max_events:
                raise RuntimeError("simulation exceeded max_events")
            t, _, task = heapq.heappop(self.events)
            self.now = max(self.now, t)
            if task.done:
                continue
            self._step_task(task, t)

        err = self.root_error
        if self.root_frame.collected:
            err = make_me(*self.root_frame.collected)
        if err is None and (self.root_frame.active > 0 or self.pending):
            err = ExcValue(type_name="DeadlockError",
                           payload=f"{self.root_frame.active} tasks blocked")
        makespan = self.now
        cm = self.cm
        energy = sum(
            b * cm.power_busy + (makespan - b) * cm.power_idle
            for b in self.busy_time
        )
        energy += (
            self.counters.asyncs * cm.energy_per_async
            + self.counters.finishes * cm.energy_per_finish
        )
        return SimResult(
            time=makespan,
            counters=self.counters,
            energy=energy,
            heap=self.heap,
            error=err,
            worker_busy=tuple(self.busy_time),
        )

    def _step_task(self, task: Task, t: float):
        """Drive the task's generator until it blocks, sleeps, or terminates."""
        gen = task.gen
        send_val = None
        while True:
            try:
                ev = gen.send(send_val)
            except StopIteration:
                self._finish_task(task, t, None)
                return
            except SimException as ex:
                self._finish_task(task, t, ex.value)
                return
            send_val = None
            kind = ev[0]
            if kind == WORK:
                c = ev[1]
                if c <= 0:
                    continue
                if task.worker is not None:
                    self.busy_time[task.worker] += c
                self.counters.work += c
                self._push(t + c, task)
                return
            if kind == SYNC:
                self._push(t, task)
                return
            if kind == SPAWN:
                body, child_locals, clock_objs = ev[1]
                ief = task.current_frame()
                child = self._make_task(body, child_locals, clock_objs, ief)
                self.counters.asyncs += 1
                self._enqueue_ready(child, t)
                continue
            if kind == JOIN:
                frame: FinishFrame = ev[1]
                if frame.active == 0:
                    continue
                frame.waiter = task
                task.blocked_on = ("join", frame)
                # X10 forbids blocking at a finish while registered on a
                # clock (ClockUseException); deregistering here keeps the
                # spawned clocked tasks' barriers live (see module docstring).
                self._deregister_clocks(task, t)
                self._block_task(task, t)
                return
            if kind == ADVANCE:
                if not task.clocks:
                    continue
                task._wait_phase = {c.id: c.phase for c in task.clocks}
                task.blocked_on = ("clock",)
                for c in task.clocks:
                    c.arrived.add(task)
                # Release the worker first so a released sibling (or this
                # task itself, re-enqueued by _clock_try_release) can use it.
                self._block_task(task, t)
                for c in task.clocks:
                    self._clock_try_release(c, t)
                return
            raise TypeError(f"unknown event {ev!r}")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def run_program(
    prog: Program,
    n_workers: int = 4,
    heap: Optional[dict] = None,
    cost_model: Optional[CostModel] = None,
    main_args: tuple = (),
    max_events: int = 50_000_000,
) -> SimResult:
    from .ir import lower_program_pending

    prog = lower_program_pending(prog)
    sched = Scheduler(prog, n_workers, cost_model, heap, max_events)
    return sched.run(main_args)


def serial_elide(s: Stmt) -> Stmt:
    """Sequential elision: async → body, finish → body, barrier → skip.

    Valid for kernels whose clocked loops are phase-separable (all our
    clocked kernels run whole parallel loops between barriers); the Fig. 12
    'Serial' baseline.
    """
    from .ir import children, rebuild, seq as seq_

    kids = [serial_elide(c) for c in children(s)]
    s2 = rebuild(s, kids) if kids else s
    if isinstance(s2, Async):
        return s2.body
    if isinstance(s2, Finish):
        return s2.body
    if isinstance(s2, Barrier):
        return Skip()
    return s2


def serial_program(prog: Program) -> Program:
    from dataclasses import replace as _replace

    return Program(
        methods=tuple(_replace(m, body=serial_elide(m.body)) for m in prog.methods),
        main=prog.main,
    )
