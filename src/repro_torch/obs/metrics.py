"""Always-on metrics plane: counters, gauges, and log-histograms with
windowed snapshot *deltas*.

Tracing (:mod:`repro.obs.trace`) answers *when* and is default-off; the
metrics registry answers *how much, lately* and is **default-on** — the
streaming visibility a serving fleet needs while the process runs.  The
cost model that makes always-on viable:

* **Emit is lock-free.**  A handle (:class:`Counter`/:class:`Gauge`/
  :class:`Histogram`) is looked up once (one registry-lock acquisition
  per metric *lifetime*) and then bumped with plain attribute writes —
  the same single-writer-per-surface discipline ``SchedTelemetry``
  already relies on.  Like the tracer, every bump starts with one read
  of a module flag, so :func:`disable` exists for A/B overhead
  measurement (``bench_grain`` gates the enabled cost ≤ 5% on the
  uniform micro-loop).
* **Readers never reset writers.**  Per-interval rates and windowed
  p50/p99 come from *diffing two cumulative snapshots*
  (:meth:`MetricsSnapshot.delta`, backed by ``LogHistogram.diff``) —
  never from zeroing live state under a writer's feet.
* **Bounded retention.**  The background :class:`Snapshotter` samples
  the registry into a deque of per-interval records (and optionally
  streams them as JSON lines): ``REPRO_METRICS=/path/metrics.jsonl``
  on any entry point, or ``--metrics-json`` on the launchers.

Metric naming: ``<surface>.<noun>[_<unit>]`` — e.g. ``sched.loops``,
``serve.queue_depth``, ``train.step_s``.  See docs/obs.md ("Online
metrics, SLOs, and the flight recorder").
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..sched.telemetry import LogHistogram

#: THE module flag — read at the top of every bump.  Metrics are
#: ALWAYS-ON by default (the opposite of the tracer): ``disable()`` is
#: for overhead A/B measurement and tests, not for production.
_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


class Counter:
    """Monotone counter.  Single-writer discipline (or tolerable races
    on a GIL runtime): the bump is a plain attribute add, no lock."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        if _ENABLED:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, in-flight)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float):
        if _ENABLED:
            self.value = v


class Histogram:
    """Cumulative :class:`LogHistogram` of positive samples (seconds by
    convention — name the metric ``*_s``).  Windowed percentiles come
    from snapshot diffing, never from resetting this object."""

    __slots__ = ("name", "hist")

    def __init__(self, name: str):
        self.name = name
        self.hist = LogHistogram()

    def observe(self, seconds: float):
        if _ENABLED:
            self.hist.add(seconds)


class MetricsSnapshot:
    """Point-in-time copy of a registry.  Cheap: counters/gauges are
    scalar copies, histograms copy their 64-int bucket list."""

    __slots__ = ("t_ns", "t_wall", "counters", "gauges", "hists")

    def __init__(self, t_ns: int, t_wall: float, counters: Dict[str, int],
                 gauges: Dict[str, float], hists: Dict[str, LogHistogram]):
        self.t_ns = t_ns
        self.t_wall = t_wall
        self.counters = counters
        self.gauges = gauges
        self.hists = hists

    def delta(self, older: "MetricsSnapshot") -> Dict[str, Any]:
        """The per-interval record between two snapshots: counter deltas
        and rates over the interval, windowed histogram percentiles via
        ``LogHistogram.diff``, and the gauges' latest values."""
        dt_s = max((self.t_ns - older.t_ns) / 1e9, 1e-9)
        counters = {k: v - older.counters.get(k, 0)
                    for k, v in sorted(self.counters.items())}
        hists = {}
        for name, h in sorted(self.hists.items()):
            old = older.hists.get(name)
            w = h.diff(old) if old is not None else h
            hists[name] = dict(n=w.n,
                               p50_ms=round(w.percentile(50) * 1e3, 4),
                               p99_ms=round(w.percentile(99) * 1e3, 4),
                               max_ms=round(w.max * 1e3, 4) if w.n else 0.0)
        return {
            "t": round(self.t_wall, 6),
            "dt_s": round(dt_s, 6),
            "counters": counters,
            "rates": {k: round(v / dt_s, 3) for k, v in counters.items()},
            "gauges": dict(sorted(self.gauges.items())),
            "hists": hists,
        }

    def summary(self) -> Dict[str, Any]:
        """Cumulative view (incident reports embed before/after pairs)."""
        return {
            "t": round(self.t_wall, 6),
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "hists": {k: dict(n=h.n,
                              p50_ms=round(h.percentile(50) * 1e3, 4),
                              p99_ms=round(h.percentile(99) * 1e3, 4))
                      for k, h in sorted(self.hists.items())},
        }


class MetricsRegistry:
    """Named metric handles, created on first use.  The registry lock is
    taken only at handle creation and at snapshot time — never on the
    bump path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        #: pull sources: ``name -> fn()`` returning a flat numeric dict,
        #: sampled into gauges at snapshot time (lets surfaces that
        #: already keep counters — SchedTelemetry, ServeStats — show up
        #: in the stream without double instrumentation on hot paths).
        self._sources: Dict[str, Callable[[], Dict[str, float]]] = {}

    def _get(self, store: Dict, name: str, cls):
        m = store.get(name)
        if m is None:
            with self._lock:
                m = store.get(name)
                if m is None:
                    m = store[name] = cls(name)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._hists, name, Histogram)

    def add_source(self, name: str, fn: Callable[[], Dict[str, float]]):
        with self._lock:
            self._sources[name] = fn

    def remove_source(self, name: str):
        with self._lock:
            self._sources.pop(name, None)

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = {k: h.hist.copy() for k, h in self._hists.items()}
            sources = list(self._sources.items())
        for prefix, fn in sources:
            try:
                for k, v in (fn() or {}).items():
                    gauges[f"{prefix}.{k}"] = v
            except Exception:  # a broken source must not kill sampling
                gauges[f"{prefix}.source_error"] = 1.0
        return MetricsSnapshot(time.perf_counter_ns(), time.time(),
                               counters, gauges, hists)

    def reset(self):
        """Tests only — production readers diff snapshots instead."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._sources.clear()


#: the process-wide default registry (surfaces bump this one)
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> MetricsSnapshot:
    return REGISTRY.snapshot()


class Snapshotter:
    """Background sampler: every ``interval_s`` it snapshots the
    registry, diffs against the previous snapshot, keeps the interval
    record in a bounded ring, and (optionally) appends it as one JSON
    line to ``path``.  ``sample()`` is public so tests and single-step
    callers can drive it deterministically without the thread."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0, path: Optional[str] = None,
                 capacity: int = 512):
        self.registry = registry if registry is not None else REGISTRY
        self.interval_s = interval_s
        self.path = path
        self.capacity = capacity
        self.records: List[Dict[str, Any]] = []
        self._prev = self.registry.snapshot()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._file = None

    def sample(self) -> Dict[str, Any]:
        cur = self.registry.snapshot()
        rec = cur.delta(self._prev)
        self._prev = cur
        self.records.append(rec)
        if len(self.records) > self.capacity:  # bounded time-series ring
            del self.records[: len(self.records) - self.capacity]
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        return rec

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.sample()

    def start(self) -> "Snapshotter":
        if self.path is not None and self._file is None:
            self._file = open(self.path, "w")
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="metrics-snapshotter",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, final_sample: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_sample:
            self.sample()  # flush the tail window
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "Snapshotter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# -- env wiring --------------------------------------------------------------

_ENV_METRICS = os.environ.get("REPRO_METRICS")
if _ENV_METRICS:
    import atexit

    _ENV_SNAPSHOTTER = Snapshotter(
        interval_s=float(os.environ.get("REPRO_METRICS_INTERVAL", "1.0")),
        path=_ENV_METRICS).start()
    atexit.register(_ENV_SNAPSHOTTER.stop)
