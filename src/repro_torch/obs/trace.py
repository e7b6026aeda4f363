"""Low-overhead span/instant tracing for the port's DCAFE runtime.

The paper's evaluation is *dynamic* evidence — #async/#finish counts and
wall-time distributions.  ``SchedTelemetry`` reproduces the counts but
throws away the *when*; this module keeps the when, cheaply enough to be
compiled into every hot path:

* **Default-off costs ~nothing.**  Every emit site starts with one read
  of the module flag ``_ENABLED`` (a plain global: no lock, no attribute
  chain).  ``trace_span`` returns a shared no-op context manager when
  disabled — no allocation, no clock read, no profiler range.
* **No locks or allocation churn on the hot path when enabled.**  Each
  thread owns a bounded ring (:class:`Ring`) reached through a
  ``threading.local``; an event is one tuple append (or slot store once
  the ring wraps).  The only lock is taken once per *thread lifetime*,
  to register a new ring.
* **Bounded memory.**  Rings hold at most ``capacity`` events; older
  events are overwritten and counted in ``Ring.dropped`` — a tracer must
  never be the thing that OOMs the job it is observing.
* **One clock with the device trace.**  While ``torch.profiler`` records,
  an enabled span also opens a ``record_function`` range named
  ``repro_torch.<cat>.<name>`` (closed on exit), so the profiler's trace
  holds the program's phases on its own clock beside the device ops.
  The rings keep ``perf_counter_ns``, which the Chrome export reads.

Event vocabulary (what the exporter and the CI conservation gate rely
on): *instants* are emitted exactly where the matching
:class:`~repro_torch.sched.telemetry.SchedTelemetry` counter is bumped —
``spawn``/``join``/``steal``/``split``/``complete``/``error``/``admit``
(each carries an integer weight ``n`` so batched bumps stay one event)
— and *spans* mark occupancy and stalls: ``cat="worker"`` spans
(``task``/``drain``/``shard_write``) are a worker's busy time,
``cat="sched"`` spans (``join_stall``/``park``/``steal``) are waiting,
and surface categories (``serve``/``train``/``ckpt``/``ep``) break a
step into phases.  See ``docs/obs.md``.

Environment wiring: ``REPRO_TRACE=/path/out.json`` enables tracing at
import and registers an ``atexit`` export, so any entry point (pytest,
launchers, benches) can be traced without code changes.
``REPRO_TRACE_CAP`` overrides the default per-thread ring capacity.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

perf_counter_ns = time.perf_counter_ns

#: THE module flag — read (unsynchronised, GIL-consistent) at the top of
#: every emit path.  Rebinding a module global is atomic, so enable/
#: disable need no lock either.
_ENABLED = False

#: Default per-thread ring capacity (events).  ~56 bytes/tuple → a few
#: MB per busy thread at the default; REPRO_TRACE_CAP overrides.
DEFAULT_CAPACITY = int(os.environ.get("REPRO_TRACE_CAP", 65536))

_capacity = DEFAULT_CAPACITY

#: ring registry: every ring ever created this process (rings of dead
#: threads stay — their events are part of the trace).  Guarded by
#: ``_reg_lock``; touched once per thread lifetime, never per event.
_rings: List["Ring"] = []
_reg_lock = threading.Lock()
_tls = threading.local()
#: epoch counter: ``clear()`` bumps it so threads holding a stale tls
#: ring re-register after a clear-and-restart (e.g. between benches)
_epoch = 0


class Ring:
    """One thread's bounded event buffer.

    An event is the tuple ``(ph, ts_ns, dur_ns, cat, name, n, args)``
    with ``ph`` in ``{"X", "i"}`` (Chrome trace-event phase codes:
    complete span / instant).  Append-until-full, then overwrite oldest
    (``dropped`` counts overwrites) — emit is O(1) and allocation-free
    beyond the event tuple itself.
    """

    __slots__ = ("events", "capacity", "idx", "dropped", "tid", "name",
                 "open_spans")

    def __init__(self, capacity: int, tid: int, name: str):
        self.events: List[Tuple] = []
        self.capacity = capacity
        self.idx = 0          # next overwrite slot once wrapped
        self.dropped = 0
        self.tid = tid
        self.name = name
        #: spans entered but not yet exited on this thread (LIFO).  An
        #: export sweeps these into truncated spans so a crash/incident
        #: dump shows what was in flight, instead of dropping them.
        self.open_spans: List["_Span"] = []

    def emit(self, ev: Tuple):
        evs = self.events
        if len(evs) < self.capacity:
            evs.append(ev)
        else:
            evs[self.idx] = ev
            self.idx = (self.idx + 1) % self.capacity
            self.dropped += 1

    def ordered(self) -> List[Tuple]:
        """Events oldest-first (un-wrapping the overwrite cursor)."""
        if len(self.events) < self.capacity or self.idx == 0:
            return list(self.events)
        return self.events[self.idx:] + self.events[: self.idx]

    def reset(self):
        self.events = []
        self.idx = 0
        self.dropped = 0


def _ring() -> Ring:
    r = getattr(_tls, "ring", None)
    if r is not None and getattr(_tls, "epoch", None) == _epoch:
        return r
    t = threading.current_thread()
    r = Ring(_capacity, t.ident or 0, t.name)
    with _reg_lock:
        _rings.append(r)
    _tls.ring = r
    _tls.epoch = _epoch
    return r


# -- control -----------------------------------------------------------------

def enabled() -> bool:
    return _ENABLED


def enable(capacity: Optional[int] = None):
    """Turn the tracer on process-wide.  ``capacity`` applies to rings
    created from now on (existing rings keep theirs)."""
    global _ENABLED, _capacity
    if capacity is not None:
        _capacity = capacity
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def clear():
    """Drop every buffered event (all rings, all threads).  Threads
    re-register their ring on next emit (epoch bump), so a bench can
    trace several isolated passes in one process."""
    global _epoch
    with _reg_lock:
        _epoch += 1
        _rings.clear()
    # the calling thread's stale tls ring is invalidated by the epoch


# -- emit --------------------------------------------------------------------

def instant(cat: str, name: str, n: int = 1,
            args: Optional[Dict[str, Any]] = None):
    """Record an instant event.  ``n`` is the event's integer weight: a
    batched counter bump (``spawns += len(tasks)``) stays ONE event, and
    the conservation cross-check sums weights, not rows."""
    if not _ENABLED:
        return
    _ring().emit(("i", perf_counter_ns(), 0, cat, name, n, args))


def complete_span(cat: str, name: str, t0_ns: int,
                  args: Optional[Dict[str, Any]] = None,
                  end_ns: Optional[int] = None):
    """Record a span that started at ``t0_ns`` and ends now (or at
    ``end_ns``) — for sites that only want the event on one outcome
    (e.g. a *successful* steal: the caller reads the clock up front, and
    failed scans emit nothing) or that stamp both ends themselves (a
    request's queue wait).  Such a span opens no profiler range."""
    if not _ENABLED:
        return
    if end_ns is not None:
        _ring().emit(("X", t0_ns, end_ns - t0_ns, cat, name, 1, args))
        return
    _ring().emit(("X", t0_ns, perf_counter_ns() - t0_ns, cat, name, 1, args))


class _Span:
    __slots__ = ("cat", "name", "args", "t0", "_ring", "_range")

    def __init__(self, cat: str, name: str, args):
        self.cat = cat
        self.name = name
        self.args = args

    def __enter__(self):
        r = _ring()
        self._ring = r
        self._range = None
        if _profiler_enabled():
            self._range = record_function(f"repro_torch.{self.cat}."
                                          f"{self.name}")
            self._range.__enter__()
        self.t0 = perf_counter_ns()
        r.open_spans.append(self)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        # De-register from the ring we registered on (a clear() between
        # enter and exit leaves a stale ring — removal is then a no-op on
        # a discarded object, which is the right outcome: cleared spans
        # are gone).  Spans nest LIFO per thread, so pop is the fast path.
        ops = self._ring.open_spans
        if ops and ops[-1] is self:
            ops.pop()
        else:  # clear() raced us, or exit out of order
            try:
                ops.remove(self)
            except ValueError:
                pass
        if _ENABLED:  # re-check: disable() mid-span drops the event
            _ring().emit(("X", self.t0, perf_counter_ns() - self.t0,
                          self.cat, self.name, 1, self.args))
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def trace_span(cat: str, name: str,
               args: Optional[Dict[str, Any]] = None):
    """Context manager timing a span.  Disabled: returns a shared no-op
    (one global read, zero allocation)."""
    if not _ENABLED:
        return _NOOP
    return _Span(cat, name, args)


# -- reading -----------------------------------------------------------------

def snapshot() -> List[Dict[str, Any]]:
    """All buffered events as dicts (oldest-first per thread), each
    carrying its thread identity — the exporter's input."""
    with _reg_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        for ph, ts, dur, cat, name, n, args in r.ordered():
            out.append(dict(ph=ph, ts_ns=ts, dur_ns=dur, cat=cat,
                            name=name, n=n, args=args, tid=r.tid,
                            thread=r.name))
    return out


def open_span_events(end_ns: Optional[int] = None) -> List[Dict[str, Any]]:
    """Spans currently in flight, as *truncated* span events: same shape
    as :func:`snapshot` entries plus ``trunc=True``, with the end forced
    to now (or ``end_ns``).  An export that only read the rings would
    silently drop whatever was mid-flight at shutdown or at an incident
    — exactly the spans a crash dump needs most."""
    end = perf_counter_ns() if end_ns is None else end_ns
    with _reg_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        for sp in list(r.open_spans):
            out.append(dict(ph="X", ts_ns=sp.t0, dur_ns=max(0, end - sp.t0),
                            cat=sp.cat, name=sp.name, n=1, args=sp.args,
                            tid=r.tid, thread=r.name, trunc=True))
    return out


def ring_stats() -> List[Dict[str, Any]]:
    """Per-ring occupancy/drop accounting (the bound tests read this)."""
    with _reg_lock:
        rings = list(_rings)
    return [dict(thread=r.name, tid=r.tid, n_events=len(r.events),
                 capacity=r.capacity, dropped=r.dropped) for r in rings]


# -- env wiring --------------------------------------------------------------

_ENV_TRACE = os.environ.get("REPRO_TRACE")
if _ENV_TRACE:
    import atexit

    enable()

    def _export_at_exit(path=_ENV_TRACE):
        from .export import write_chrome_trace

        write_chrome_trace(path)

    atexit.register(_export_at_exit)
