"""Seeded deterministic fault injection + bounded retries.

The paper's third contribution extends DCAFE to RTP programs that may
throw: AFE may move *where* a join happens, never *whether* an exception
surfaces.  Proving that needs faults on demand — this module is the
chaos harness the executors, checkpointer, batcher, and EP round consult
at their emit sites, plus the :class:`RetryPolicy` those surfaces use to
absorb transient failures.

Design rules:

* **Default-off costs one module-global read.**  Every hook site calls
  :func:`active` first; with no plan installed that is a single ``None``
  check — the same discipline as ``repro.obs.trace._ENABLED``.
* **Deterministic by construction.**  A :class:`FaultPlan` is seeded;
  ``every=N`` specs fire on exact poke counts (thread interleaving moves
  *which* item a fault hits, never *how many* fire over M pokes — the
  conservation gates depend only on counts), and ``rate`` specs draw
  from per-spec seeded RNGs under the plan lock.
* **Injection is accounted exactly.**  ``plan.injected`` counts every
  fired fault per ``(site, kind)`` so benches and tests can gate
  ``injected == collected`` with zero tolerance.

Sites wired in this repo (see docs/sched.md):

=================  =====================================================
``sched.item``     every loop item both executors run (raise / slow)
``sched.worker``   worker loop top (worker_death — the thread exits)
``ckpt.shard``     one checkpoint shard write attempt (raise / slow)
``serve.request``  one decode step of one request slot (raise / slow)
``ep.round``       one EP dispatch round (shard_loss)
=================  =====================================================
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Type

from ..obs import trace as obs


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultPlan.poke` at a matching ``raise`` spec."""


class WorkerDeath(Exception):
    """Internal signal: a worker thread was told to die (never escapes
    the executor — the worker unwinds after re-queueing its work)."""


class ShardLossError(RuntimeError):
    """An EP shard became unreachable mid-round."""

    def __init__(self, shard: int):
        super().__init__(f"ep shard {shard} lost")
        self.shard = shard


KINDS = ("raise", "slow", "worker_death", "shard_loss")


@dataclass(frozen=True)
class FaultSpec:
    """One fault source: at ``site``, inject ``kind`` either every
    ``every``-th poke (exact, interleaving-independent counts) or with
    probability ``rate`` per poke (seeded), at most ``max_injections``
    times.  ``delay_s`` is the stall for ``slow``; ``shard`` the victim
    for ``shard_loss``."""

    site: str
    kind: str = "raise"
    every: int = 0
    rate: float = 0.0
    delay_s: float = 0.0
    shard: int = 0
    max_injections: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.every <= 0 and self.rate <= 0.0:
            raise ValueError("FaultSpec needs every>0 or rate>0")


class FaultPlan:
    """A seeded set of :class:`FaultSpec`\\ s plus exact injection
    accounting.  All decisions happen under one lock (poke sites are
    failure paths or per-item hooks, not per-token hot loops)."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}          # site -> pokes seen
        #: fired faults per (site, kind) — the bench's "injected" side
        self.injected: Dict[Tuple[str, str], int] = {}
        self._rngs = [random.Random((self.seed << 8) ^ (i * 0x9E3779B9))
                      for i in range(len(self.specs))]

    def _fire(self, site: str, kinds: Tuple[str, ...]):
        """Under the lock: advance the site's poke counter and return the
        specs that fire this poke (in declaration order)."""
        fired = []
        with self._lock:
            seq = self._seq.get(site, 0) + 1
            self._seq[site] = seq
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.kind not in kinds:
                    continue
                key = (site, spec.kind)
                if (spec.max_injections is not None
                        and self.injected.get(key, 0) >= spec.max_injections):
                    continue
                hit = (spec.every > 0 and seq % spec.every == 0) or (
                    spec.rate > 0.0 and self._rngs[i].random() < spec.rate)
                if hit:
                    self.injected[key] = self.injected.get(key, 0) + 1
                    fired.append(spec)
        return fired

    # -- hook entry points ---------------------------------------------------

    def poke(self, site: str):
        """Item-level hook: may sleep (``slow``) and/or raise
        :class:`InjectedFault` (``raise``)."""
        fired = self._fire(site, ("raise", "slow"))
        if not fired:
            return
        boom = False
        for spec in fired:
            if spec.kind == "slow" and spec.delay_s > 0:
                time.sleep(spec.delay_s)
            elif spec.kind == "raise":
                boom = True
        if boom:
            obs.instant("sched", "fault", args={"site": site})
            raise InjectedFault(f"injected fault at {site}")

    def should_die(self, site: str = "sched.worker") -> bool:
        """Worker-loop hook: True when a ``worker_death`` spec fires."""
        fired = self._fire(site, ("worker_death",))
        if fired:
            obs.instant("sched", "fault", args={"site": site,
                                                "kind": "worker_death"})
            return True
        return False

    def lost_shard(self, site: str = "ep.round") -> Optional[int]:
        """EP-round hook: the victim shard index when a ``shard_loss``
        spec fires, else None."""
        fired = self._fire(site, ("shard_loss",))
        if fired:
            shard = fired[0].shard
            obs.instant("sched", "fault", args={"site": site, "shard": shard})
            return shard
        return None

    # -- accounting ----------------------------------------------------------

    def injected_total(self, site: Optional[str] = None,
                       kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(c for (s, k), c in self.injected.items()
                       if (site is None or s == site)
                       and (kind is None or k == kind))

    def summary(self) -> Dict[str, int]:
        with self._lock:
            return {f"{s}/{k}": c for (s, k), c in sorted(self.injected.items())}


# -- process-wide hook (default off) -----------------------------------------

_PLAN: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The installed plan, or None.  Hook sites read this exactly once
    per poke; None is the (default) free path."""
    return _PLAN


def install(plan: FaultPlan):
    global _PLAN
    _PLAN = plan


def uninstall():
    global _PLAN
    _PLAN = None


@contextmanager
def injected_faults(plan: FaultPlan):
    """``with faults.injected_faults(FaultPlan([...], seed=0)) as plan:``
    — installs the plan for the block, uninstalls on exit (also on
    raise), and yields it for injection accounting."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


# -- retries -----------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts with exponential backoff and deterministic
    seeded jitter.  Jitter keys must be *stable integers* (shard index,
    slot index) — never ``hash(str)``, which is salted per process and
    would unseed the schedule."""

    attempts: int = 3
    base_delay_s: float = 0.0     # 0 = no sleeping (test/bench default)
    max_delay_s: float = 0.05
    backoff: float = 2.0
    jitter: float = 0.25          # fraction of the delay, uniform
    seed: int = 0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("RetryPolicy.attempts must be >= 1")

    def delay_s(self, attempt: int, key: int = 0) -> float:
        """Backoff before retry number ``attempt`` (0-based) of the task
        keyed ``key``.  Deterministic: same (seed, key, attempt) → same
        delay."""
        if self.base_delay_s <= 0:
            return 0.0
        d = min(self.base_delay_s * (self.backoff ** attempt),
                self.max_delay_s)
        rng = random.Random((self.seed << 24) ^ (int(key) << 8) ^ attempt)
        return d * (1.0 + self.jitter * rng.random())

    def run(self, fn: Callable[[], "object"], *, key: int = 0,
            site: str = "retry", telemetry=None,
            retry_on: Tuple[Type[BaseException], ...] = (Exception,),
            sleep: Callable[[float], None] = time.sleep):
        """Call ``fn`` up to ``attempts`` times.  Each retry bumps
        ``telemetry.retries`` (via :meth:`record_retry`) and emits a
        ``sched.retry`` instant — emit-where-you-bump, so the obs
        conservation gate covers retries too.  The final failure
        propagates unwrapped."""
        last: Optional[BaseException] = None
        for attempt in range(self.attempts):
            try:
                return fn()
            except retry_on as e:
                last = e
                if attempt + 1 >= self.attempts:
                    raise
                if telemetry is not None:
                    telemetry.record_retry(site)
                obs.instant("sched", "retry", args={"site": site})
                d = self.delay_s(attempt, key)
                if d > 0:
                    sleep(d)
        raise last  # unreachable; keeps type-checkers honest
