"""Incident flight recorder, per-tenant SLO burn-rate monitor, and the
finish-scope stall watchdog.

The PR-6 trace rings keep recording cheaply; what changes here is *when
the export happens*: not at atexit, but the moment something goes wrong
— an SLO error budget burning out, a ``FinishScope`` join pending past
its deadline, a join surfacing ``MultipleExceptions``, or an EP round
running degraded.  Each trigger dumps a structured **incident report**:

* ``trigger`` / ``reason`` / the implicated tenant, scope, shard, site;
* ``metrics_before`` / ``metrics_after`` — registry snapshots from the
  last arm point and from the moment of the incident;
* ``telemetry_window`` — the counter *delta* since the recorder was
  armed (:meth:`SchedTelemetry.counters_snapshot` diffing);
* ``trace`` — the trace window since arm, spans still in flight swept
  in as truncated spans (``"trunc": true``);
* ``crosscheck`` — the PR-6 conservation contract applied to exactly
  that window: the instants in the dumped trace must re-derive the
  counter deltas.  An incident report that lies about its own window is
  itself a failure (``gates slo`` replays this in CI).

Wiring is the faults-harness idiom: a module-level recorder installed
with :func:`install` (default ``None`` = every hook is one global read
and out), consulted by the executors (join failures/timeouts), the
batcher (:class:`SloMonitor`), EP dispatch (degraded rounds), and the
:class:`StallWatchdog` thread.  See docs/obs.md ("Online metrics, SLOs,
and the flight recorder").
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..sched.telemetry import diff_counters
from . import export as _export
from . import metrics as _metrics
from . import trace as _trace

#: incident triggers (the report's ``trigger`` field)
TRIGGERS = ("slo_burn", "join_stall", "multiple_exceptions", "ep_degraded")

INCIDENT_SCHEMA = 1


class FlightRecorder:
    """Triggered trace export + structured incident reports.

    ``arm()`` marks the window start: it clears the trace rings (when
    tracing is on) and snapshots the telemetry counters and the metrics
    registry.  ``record()`` dumps everything since — so the embedded
    trace window and the embedded counter delta describe the *same*
    interval and must reconcile under ``crosscheck()``.
    """

    def __init__(self, telemetry=None, out_dir: Optional[str] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 capacity: int = 64, min_interval_s: float = 0.0):
        self.telemetry = telemetry
        self.out_dir = out_dir
        self.registry = registry if registry is not None else _metrics.REGISTRY
        self.capacity = capacity
        self.min_interval_s = min_interval_s
        self.incidents: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._baseline: Optional[Dict] = None
        self._metrics_before: Optional[_metrics.MetricsSnapshot] = None
        self._last_fire: Dict[str, float] = {}
        self._seq = 0

    def arm(self, clear_trace: bool = True) -> "FlightRecorder":
        """Start a fresh window.  With tracing enabled the rings are
        cleared so events-since-arm is exactly what the rings hold."""
        if clear_trace and _trace.enabled():
            _trace.clear()
        if self.telemetry is not None:
            self._baseline = self.telemetry.counters_snapshot()
        self._metrics_before = self.registry.snapshot()
        return self

    def record(self, trigger: str, reason: str, *,
               tenant: Optional[str] = None, scope: Optional[str] = None,
               shard: Optional[Any] = None, site: Optional[str] = None,
               extra: Optional[Dict[str, Any]] = None,
               ) -> Optional[Dict[str, Any]]:
        """Fire one incident.  Returns the report, or ``None`` when the
        per-trigger rate limit suppressed it.  Never raises: a flight
        recorder must not take down the thing it is observing — capture
        failures are reported inside the incident instead."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown trigger {trigger!r} (not in "
                             f"{TRIGGERS})")
        now = time.perf_counter()
        with self._lock:
            last = self._last_fire.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_fire[trigger] = now
            self._seq += 1
            seq = self._seq
        report: Dict[str, Any] = {
            "schema": INCIDENT_SCHEMA,
            "seq": seq,
            "trigger": trigger,
            "reason": reason,
            "t_wall": time.time(),
            "implicated": {k: v for k, v in dict(
                tenant=tenant, scope=scope, shard=shard, site=site,
            ).items() if v is not None},
            "extra": extra or {},
        }
        try:
            after = self.registry.snapshot()
            if self._metrics_before is not None:
                report["metrics_before"] = self._metrics_before.summary()
                report["metrics_window"] = after.delta(self._metrics_before)
            report["metrics_after"] = after.summary()
            if self.telemetry is not None and self._baseline is not None:
                report["telemetry_window"] = diff_counters(
                    self.telemetry.counters_snapshot(), self._baseline)
            if _trace.enabled():
                doc = _export.chrome_trace()  # sweeps open spans (trunc)
                report["trace"] = doc
                if "telemetry_window" in report:
                    report["crosscheck"] = _export.crosscheck(
                        doc, report["telemetry_window"])
        except Exception as e:  # pragma: no cover - capture must not kill
            report["capture_error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            self.incidents.append(report)
            if len(self.incidents) > self.capacity:
                del self.incidents[: len(self.incidents) - self.capacity]
        self._persist(report)
        return report

    def _persist(self, report: Dict[str, Any]):
        if self.out_dir is None:
            return
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            name = f"incident-{report['seq']:03d}-{report['trigger']}.json"
            with open(os.path.join(self.out_dir, name), "w") as f:
                json.dump(report, f, indent=1)
        except OSError:  # pragma: no cover - best-effort persistence
            pass

    def count(self, trigger: Optional[str] = None) -> int:
        with self._lock:
            if trigger is None:
                return len(self.incidents)
            return sum(1 for i in self.incidents if i["trigger"] == trigger)


#: the module-level recorder: ``None`` (default) makes every hook one
#: global read — the faults-harness default-off idiom.
_RECORDER: Optional[FlightRecorder] = None


def install(recorder: FlightRecorder) -> FlightRecorder:
    global _RECORDER
    _RECORDER = recorder
    return recorder


def uninstall():
    global _RECORDER
    _RECORDER = None


def active() -> Optional[FlightRecorder]:
    return _RECORDER


class recording:
    """``with recording(FlightRecorder(...)) as rec:`` — scoped install,
    mirroring ``injected_faults`` from the fault harness."""

    def __init__(self, recorder: FlightRecorder):
        self.recorder = recorder

    def __enter__(self) -> FlightRecorder:
        return install(self.recorder)

    def __exit__(self, *exc):
        uninstall()
        return False


# -- executor-side trigger hooks ---------------------------------------------
# Called from FinishScope.wait; one global read when no recorder is
# installed, so the hot path cost matches the faults harness.

def on_join_failed(scope: Any, error_count: int,
                   site: Optional[str] = None):
    rec = _RECORDER
    if rec is None:
        return
    rec.record("multiple_exceptions",
               f"finish scope join surfaced {error_count} task error(s)",
               scope=type(scope).__name__, site=site,
               extra={"error_count": int(error_count)})


def on_join_timeout(scope: Any, pending: int, timeout_s: float):
    rec = _RECORDER
    if rec is None:
        return
    rec.record("join_stall",
               f"finish scope wait timed out after {timeout_s:.3f}s with "
               f"{pending} waitable(s) pending",
               scope=type(scope).__name__,
               extra={"pending": int(pending),
                      "timeout_s": float(timeout_s)})


def on_ep_degraded(dead_shards: Any, round_errors: int = 0):
    rec = _RECORDER
    if rec is None:
        return
    dead = sorted(dead_shards)
    rec.record("ep_degraded",
               f"EP round ran degraded: {len(dead)} dead shard(s) "
               f"{dead}, lanes rerouted to live shards",
               shard=dead[0] if dead else None, site="ep.round",
               extra={"dead_shards": dead,
                      "round_errors": int(round_errors)})


# -- stall watchdog ----------------------------------------------------------

class StallWatchdog:
    """Daemon thread that fires a ``join_stall`` incident when a watched
    ``FinishScope`` is still pending past its deadline — the stall is
    detected even when nobody is blocked in ``wait(timeout=...)`` (the
    caller may be wedged *inside* the scope, which is exactly when an
    external observer is needed).

    Scopes are watched by duck type: anything with ``pending()`` works.
    A watched scope fires **at most once** (deterministic incident
    counts for the seeded fault tests), and a scope observed quiescent
    is dropped from the watch list.
    """

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 poll_s: float = 0.01):
        self.recorder = recorder
        self.poll_s = poll_s
        self.fired = 0
        self._watched: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_token = 0

    def watch(self, scope: Any, deadline_s: float,
              label: Optional[str] = None) -> int:
        """Register ``scope``: if it still has pending waitables
        ``deadline_s`` from now, a ``join_stall`` incident fires."""
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._watched[token] = dict(
                scope=scope, deadline=time.perf_counter() + deadline_s,
                deadline_s=deadline_s, label=label or f"scope-{token}")
        self._ensure_thread()
        return token

    def unwatch(self, token: int):
        with self._lock:
            self._watched.pop(token, None)

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="stall-watchdog",
                                            daemon=True)
            self._thread.start()

    def scan(self) -> int:
        """One pass over the watch list (public so tests can drive the
        watchdog without thread-timing dependence).  Returns how many
        incidents this pass fired."""
        now = time.perf_counter()
        with self._lock:
            entries = list(self._watched.items())
        fired = 0
        for token, ent in entries:
            try:
                pending = ent["scope"].pending()
            except Exception:  # a broken scope must not kill the thread
                pending = 0
            if pending == 0:
                self.unwatch(token)
                continue
            if now >= ent["deadline"]:
                self.unwatch(token)  # at most one incident per scope
                fired += 1
                self.fired += 1
                rec = self.recorder if self.recorder is not None \
                    else _RECORDER
                if rec is not None:
                    rec.record(
                        "join_stall",
                        f"watchdog: {ent['label']} still has {pending} "
                        f"waitable(s) pending {ent['deadline_s']:.3f}s "
                        f"past its deadline",
                        scope=ent["label"],
                        extra={"pending": int(pending),
                               "deadline_s": float(ent["deadline_s"])})
        return fired

    def _loop(self):
        while not self._stop.wait(self.poll_s):
            self.scan()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


# -- per-tenant SLO burn-rate monitor ----------------------------------------

class TenantBudget:
    """One tenant's sliding-window SLO accounting (monitor-internal)."""

    __slots__ = ("name", "cost_slo", "allowed", "observed_steps",
                 "bad_steps", "fired", "first_burn_step", "costs_seen",
                 "failures_seen", "depth_window")

    def __init__(self, name: str, cost_slo: float, allowed: float):
        self.name = name
        self.cost_slo = cost_slo       # per-token decode-cost ceiling
        self.allowed = allowed         # bad steps the budget tolerates
        self.observed_steps = 0
        self.bad_steps = 0
        self.fired = False
        self.first_burn_step = None
        self.costs_seen = 0            # cursor into decode_step_costs
        self.failures_seen = 0         # failed+expired seen so far
        self.depth_window: List[int] = []

    @property
    def budget_spent(self) -> float:
        """Fraction of the error budget consumed (≥ 1.0 = burned)."""
        return self.bad_steps / self.allowed if self.allowed > 0 else 0.0

    def summary(self) -> Dict[str, Any]:
        return dict(tenant=self.name, cost_slo=self.cost_slo,
                    allowed_bad_steps=self.allowed,
                    observed_steps=self.observed_steps,
                    bad_steps=self.bad_steps,
                    budget_spent=round(self.budget_spent, 4),
                    first_burn_step=self.first_burn_step)


class SloMonitor:
    """Burn-rate/error-budget accounting layered on the batcher's
    ``ServeStats`` — called once per ``ContinuousBatcher.step()``.

    The SLO model (docs/obs.md has the math): a step is **bad** for a
    tenant when any of its decode-step costs recorded that step exceeds
    the tenant's per-token cost ceiling (``TenantQueue.slo_cost``,
    derived from ``slo_steps`` when unset), or one of its requests
    failed/expired that step.  The error budget allows
    ``budget_frac × horizon`` bad steps; when a tenant's ``bad_steps``
    exceeds that, its budget has burned and a single ``slo_burn``
    incident fires (the burn *rate* — bad fraction / budget fraction —
    goes in the report).  Everything is integer step counts over seeded
    runs, so verdicts replay deterministically from the artifact.
    """

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 budget_frac: float = 0.1, horizon: int = 256,
                 depth_window: int = 64):
        self.recorder = recorder
        self.budget_frac = budget_frac
        self.horizon = horizon
        self.depth_window = depth_window
        self.tenants: Dict[str, TenantBudget] = {}
        self.incidents_fired = 0

    # -- SLO derivation ------------------------------------------------------

    @staticmethod
    def derive_cost_slo(slo_steps: int) -> float:
        """Per-token decode-cost ceiling from a whole-request deadline:
        a request that must finish in ``slo_steps`` steps cannot afford
        individual decode steps costing a large fraction of it.  The
        ceiling is ``max(2, slo_steps / 4)`` vtime steps — pure decode
        (cost 1) always passes, and a co-scheduled whole-prompt prefill
        (cost ≈ 1 + prompt_len) blows it, which is the DLBC chunking
        argument in SLO form."""
        return max(2.0, slo_steps / 4.0)

    def _budget(self, name: str, slo_steps: int,
                slo_cost: float) -> TenantBudget:
        b = self.tenants.get(name)
        if b is None:
            cost = slo_cost if slo_cost > 0 else self.derive_cost_slo(
                slo_steps)
            b = self.tenants[name] = TenantBudget(
                name, cost, self.budget_frac * self.horizon)
        return b

    # -- per-step observation ------------------------------------------------

    def observe(self, batcher, now: int):
        """One batcher step: fold each SLO-carrying tenant's new decode
        costs, failure/expiry deltas, and queue depth into its budget."""
        if batcher.registry is not None:
            names = batcher.registry.names()
        else:
            names = ["default"]
        for name in names:
            slo = batcher._slo_of(name)
            if slo <= 0:
                continue
            slo_cost = 0.0
            if batcher.registry is not None:
                slo_cost = getattr(batcher.registry.get(name),
                                   "slo_cost", 0.0)
            b = self._budget(name, slo, slo_cost)
            if batcher.registry is not None:
                st = batcher.tenant_stats.get(name)
                depth = len(batcher.registry.get(name).queue)
            else:
                st = batcher.stats
                depth = len(batcher.queue)
            if st is None:
                continue
            b.observed_steps += 1
            b.depth_window.append(depth)
            if len(b.depth_window) > self.depth_window:
                del b.depth_window[0]
            _metrics.gauge(f"serve.queue_depth.{name}").set(depth)
            costs = st.decode_step_costs
            new_costs = costs[b.costs_seen:]
            b.costs_seen = len(costs)
            failures = st.failed + st.expired
            bad = (any(c > b.cost_slo for c in new_costs)
                   or failures > b.failures_seen)
            b.failures_seen = failures
            if not bad:
                continue
            b.bad_steps += 1
            _metrics.counter(f"serve.slo_bad_steps.{name}").inc()
            if b.bad_steps > b.allowed and not b.fired:
                b.fired = True
                b.first_burn_step = now
                self.incidents_fired += 1
                self._fire(b, depth_growth=self._depth_growth(b))

    def _depth_growth(self, b: TenantBudget) -> int:
        if len(b.depth_window) < 2:
            return 0
        return b.depth_window[-1] - b.depth_window[0]

    def _fire(self, b: TenantBudget, depth_growth: int):
        rec = self.recorder if self.recorder is not None else _RECORDER
        bad_frac = b.bad_steps / max(1, b.observed_steps)
        burn_rate = bad_frac / self.budget_frac
        _metrics.counter("serve.slo_incidents").inc()
        if rec is None:
            return
        rec.record(
            "slo_burn",
            f"tenant {b.name!r} burned its SLO error budget: "
            f"{b.bad_steps} bad steps > {b.allowed:.1f} allowed "
            f"(burn rate {burn_rate:.2f}x, queue depth growth "
            f"{depth_growth:+d} over the window)",
            tenant=b.name,
            extra=dict(b.summary(), burn_rate=round(burn_rate, 4),
                       budget_frac=self.budget_frac, horizon=self.horizon,
                       queue_depth_growth=depth_growth))

    def summary(self) -> Dict[str, Any]:
        return {
            "budget_frac": self.budget_frac,
            "horizon": self.horizon,
            "incidents_fired": self.incidents_fired,
            "tenants": {n: b.summary()
                        for n, b in sorted(self.tenants.items())},
        }
