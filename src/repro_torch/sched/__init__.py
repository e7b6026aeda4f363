"""repro.sched — the unified DLBC/DCAFE scheduling-policy engine.

The paper's core contribution is a *runtime policy*, not a compiler pass:
read the idle-worker count, chunk the remaining work equally among
``idle + 1`` workers with the remainder spread one-per-chunk from the
front and the smallest chunk kept by the caller, and fall back to a
serial block that re-probes after every iteration (Fig. 6, §3.2).

This package makes that policy a first-class, pluggable engine shared by
every execution surface in the repo:

* :mod:`repro.sched.policy` — ``SchedPolicy`` implementations (``Serial``,
  ``LC``, ``DLBC``, ``DCAFE``) driven by one canonical ``chunk_plan``
  that owns the Fig. 6 remainder-spread arithmetic;
* :mod:`repro.sched.capacity` — ``CapacityProvider`` abstractions over
  "idle workers": simulated workers, host threads, device decode slots;
* :mod:`repro.sched.executors` — ``ThreadExecutor`` (host thread pool,
  with a work-stealing variant) and ``SlotExecutor`` (device-slot
  admission for the serving batcher);
* :mod:`repro.sched.tenancy` — multi-tenant admission: per-tenant
  queues (``TenantRegistry``) and weighted deficit-round-robin refill
  (``WeightedRefillPolicy``, ``"wdlbc"``) over one slot executor;
* :mod:`repro.sched.faults` — seeded deterministic fault injection
  (``FaultPlan``: raise / slow / worker-death / shard-loss) behind a
  default-off hook, and bounded retries with deterministic backoff
  (``RetryPolicy``) — the paper's exception extension made testable;
* :mod:`repro.sched.telemetry` — Fig. 10-style spawn/join counters plus
  latency distributions (p50/p99) emitted as JSON for the benchmarks.

Consumers: ``repro.core.dlbc``/``repro.core.lc`` (IR codegen chunk
arithmetic), ``repro.core.runtime`` (simulated-worker capacity and
counters), ``repro.data.pool`` (host pool), ``repro.serve.batcher``
(slot refill).  See ``docs/sched.md``.
"""

from .capacity import (  # noqa: F401
    CapacityProvider, ExpertCapacityProvider, FixedCapacity, PoolCapacity,
    SimWorkerCapacity, SlotCapacity,
)
from .policy import (  # noqa: F401
    DCAFE, DLBC, LC, POLICIES, ChunkPlan, Decision, GrainController,
    GrainPlan, SchedPolicy, Serial, chunk_plan, fig6_chunk_end, fig6_eq,
    fig6_next, fig6_rem0, fig6_tot, get_policy, static_chunk_size,
    static_plan,
)
from .tenancy import (  # noqa: F401
    TenantQueue, TenantRegistry, WeightedRefillPolicy, ensure_weighted,
)
from .executors import (  # noqa: F401
    CancelToken, FinishScope, JoinOutcome, MultipleExceptions, RangeLatch,
    RangeTask, SlotExecutor, TaskError, TaskEvent, ThreadExecutor,
    WorkStealingExecutor,
)
from .faults import (  # noqa: F401
    FaultPlan, FaultSpec, InjectedFault, RetryPolicy, ShardLossError,
    WorkerDeath, injected_faults,
)
from .telemetry import (  # noqa: F401
    ExchangeCounters, LogHistogram, SchedCounters, SchedTelemetry,
    diff_counters, percentile,
)
