"""Continuous-batching serving loop with DLBC slot scheduling and
DLBC-chunked prefill — the port's copy of ``repro/serve/batcher.py``.

Everything but the device launches is the reference's code: admission,
tenancy, SLOs, fault containment, obs spans and stats.  The launches go
through :mod:`repro_torch.models.model` on ``device`` (the card unless
``device="cpu"``), and every launch gets COPIES of the host-side slot
state (``torch.tensor``, never a view of the numpy arrays the loop then
mutates).

The decode step runs a fixed-width batch of slots (static shapes for
XLA).  The scheduler is the DLBC policy over *device slots*:

* an arriving request is admitted only if an idle slot exists (the
  "spawn only when idle workers exist" rule);
* when no slot is idle, requests queue and the current batch keeps
  decoding ("serial block") — after every decode step the scheduler
  re-checks the queue against freed slots (per-iteration re-check);
* freed slots (finished sequences) are refilled in FIFO order with the
  remainder-spread priority of Fig. 6 (oldest request → lowest slot).

Compare with the LC baseline (``policy="lc"``): fixed batching — wait
until a full batch accumulates, run it to completion, then take the next
batch (static chunking of requests).  The benchmark measures mean/p99
latency and slot utilisation for both.

Multi-tenant serving (``policy="wdlbc"`` or a ``tenants=`` weight map)
keeps the SAME slot arithmetic over ONE :class:`SlotExecutor` and layers
per-tenant queues on top: the base policy still sizes each refill to the
idle-slot count, and a weighted deficit-round-robin
(:class:`repro.sched.tenancy.WeightedRefillPolicy`) picks *which tenant*
each freed slot goes to.  With a single tenant the admission trace is
step-for-step identical to plain DLBC (pinned by
``tests/test_serve_regression.py``).

Prefill is REAL and chunked.  On placement, prompt tokens ``0..L-2``
are written into the KV cache by batched span-prefill launches
(:func:`repro.models.model.prefill_step` — per-row cache indices, padded
rows inert), and decode then starts from the LAST prompt token at
position ``L-1``.  The span is split into DLBC-planned chunks: each
step, every prefilling slot asks ``policy.prefill_chunk_len(remaining,
busy, cap)`` — the Fig. 6 arithmetic with the *decoding* slot count as
the contended capacity, re-probed per step like the serial block — so a
long prompt interleaves with its neighbours' decode steps instead of
holding them hostage for its whole prefill.  Chunked prefill is bitwise
identical to whole-prompt prefill (every chunk runs through the same
static launch buffer and each query attends over the full cache; pinned
by ``tests/test_prefill.py``).  AFE: each request holds ONE
:class:`FinishScope` spanning all its prefill chunks plus decode, joined
exactly once at completion — telemetry counts joins == requests, with
chunk work in the separate ``prefill_chunks``/``prefill_tokens``
counters and ``serve.prefill_chunk`` trace spans.

The admission decision itself lives in :mod:`repro.sched` (the shared
policy engine): this module delegates slot refill to
:class:`repro.sched.executors.SlotExecutor`, whose telemetry counts
admissions as spawns and completed sequences as joins (Fig. 10
analogues) alongside latency distributions — per tenant as well as
globally, with the conservation invariant (per-tenant sums == globals)
gated in CI.

Cache positions are tracked PER SLOT and passed to ``decode_step`` /
``prefill_step`` as a ``(n_slots,)`` vector: a freshly refilled slot
prefills/decodes against ITS OWN position while its neighbours keep
decoding at theirs.  (The previous scheme shared one ``max(slot_pos)``
index across the batch, so a refill mid-decode wrote the new request's
KV at the old request's position and attended over stale entries — see
the refill-mid-decode regression test.)  Attention-family caches are
fully isolated by the per-slot index + validity mask; SSM/hybrid
recurrent state is not position-indexed and would additionally need a
per-slot state reset on refill — the serving path is exercised with
attention families.

Step cost is accounted in slot-step *token units*: a step costs 1 for
the decode launch plus the largest prefill chunk that shared it.
``ServeStats.decode_step_costs`` records that cost once per decoded
token, so the per-token decode-latency distribution (and its p99)
directly exposes how much prefill work stalled decoders — the SLO
surface ``bench_tenants`` gates under a long-prompt adversary.

Fault containment is PER REQUEST: a request that raises mid-serve (the
``serve.request`` fault-injection site, or a failed prefill collected
by its scope) frees its slot and is requeued under a bounded
:class:`~repro.sched.faults.RetryPolicy` budget, then counted
``ServeStats.failed`` — neighbouring slots keep decoding bitwise
identically (pinned by ``tests/test_faults.py``).  Tenants may carry an
SLO deadline (``slos=`` or ``TenantQueue.slo_steps``, in decode steps):
requests still in-slot past it are evicted and counted ``expired``, and
the request's one scope join uses a timeout derived from the same SLO
(:class:`~repro.sched.executors.JoinOutcome` distinguishes "timed out"
from "done with failures").
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import model as MDL
from ..obs import metrics as obs_metrics
from ..obs import trace as obs
from ..obs.monitor import SloMonitor
from ..sched import faults
from ..sched.executors import FinishScope, RangeLatch, SlotExecutor
from ..sched.faults import RetryPolicy
from ..sched.policy import SchedPolicy
from ..sched.telemetry import percentile
from ..sched.tenancy import TenantRegistry, WeightedRefillPolicy

#: always-on metrics plane: one bump set per STEP, never per token
_MX_SERVE_STEPS = obs_metrics.counter("serve.steps")
_MX_QUEUE_DEPTH = obs_metrics.gauge("serve.queue_depth")
_MX_STEP_COST = obs_metrics.gauge("serve.step_cost")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    arrive_step: int = 0
    start_step: Optional[int] = None
    done_step: Optional[int] = None
    tokens: list = field(default_factory=list)
    tenant: str = "default"
    #: how many times this request has been (re-)admitted after a
    #: failure — compared against ``RetryPolicy.attempts`` before a
    #: poisoned request is requeued instead of counted ``failed``
    attempts: int = 0


@dataclass
class ServeStats:
    steps: int = 0
    busy_slot_steps: int = 0
    total_slot_steps: int = 0
    #: step index at which this stats object started integrating — 0 for
    #: the global stats; for a tenant first seen mid-run it is the
    #: backfill point, so ``steps``/``total_slot_steps`` stay comparable
    #: across tenants (conservation: every tenant's denominators equal
    #: the global ones).
    first_step: int = 0
    #: requests killed by the cache bound (``slot_pos`` ran into
    #: ``cache_len``) before producing ``max_new`` tokens — counted
    #: separately from normal completions so an SLO gate cannot be
    #: satisfied by silently cutting sequences short.
    truncated: int = 0
    #: requests that raised mid-serve (poisoned) and exhausted their
    #: retry budget — the slot was freed, the neighbours kept decoding
    #: (containment), and no latency sample was recorded for them
    failed: int = 0
    #: requests evicted past their tenant's ``slo_steps`` deadline —
    #: the slot frees for queued work instead of a stale request
    #: holding it (counted apart from ``failed``: nothing raised)
    expired: int = 0
    latencies: list = field(default_factory=list)
    queue_waits: list = field(default_factory=list)
    #: one entry per decoded token: the slot-step cost of the step that
    #: produced it (1 + the largest prefill chunk sharing the step) —
    #: the per-token decode latency surface in virtual-time units.
    decode_step_costs: list = field(default_factory=list)

    @property
    def utilization(self) -> float:
        return self.busy_slot_steps / max(1, self.total_slot_steps)

    @property
    def p50_latency(self) -> float:
        return percentile(self.latencies, 50)

    @property
    def p99_latency(self) -> float:
        return percentile(self.latencies, 99)

    @property
    def p50_decode_cost(self) -> float:
        return percentile(self.decode_step_costs, 50)

    @property
    def p99_decode_cost(self) -> float:
        return percentile(self.decode_step_costs, 99)

    def summary(self) -> Dict:
        return dict(steps=self.steps, utilization=round(self.utilization, 4),
                    n_done=len(self.latencies),
                    truncated=self.truncated,
                    failed=self.failed,
                    expired=self.expired,
                    p50_latency=self.p50_latency,
                    p99_latency=self.p99_latency,
                    mean_queue_wait=(float(np.mean(self.queue_waits))
                                     if self.queue_waits else 0.0),
                    n_decode_tokens=len(self.decode_step_costs),
                    p50_decode_cost=self.p50_decode_cost,
                    p99_decode_cost=self.p99_decode_cost)


class _PrefillState:
    """Progress of one request's span prefill: the prompt prefix still
    owed to the cache, a cursor, and the range latch its chunks
    discharge into (one latch per request — the AFE join waits it)."""

    __slots__ = ("tokens", "cursor", "latch")

    def __init__(self, tokens: List[int], latch: RangeLatch):
        self.tokens = tokens
        self.cursor = 0
        self.latch = latch


class ContinuousBatcher:
    """Step-synchronous simulator of the serving loop (decode steps are the
    clock — on hardware each step is one ``serve_step`` launch)."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 cache_len: int = 256,
                 policy: Union[str, SchedPolicy] = "dlbc",
                 tenants: Optional[Dict[str, float]] = None,
                 prefill_chunk: int = 32,
                 prefill_mode: str = "chunked",
                 retry: Optional[RetryPolicy] = None,
                 slos: Optional[Dict[str, int]] = None,
                 monitor: Optional[SloMonitor] = None,
                 device: Optional[Union[str, torch.device]] = None):
        assert isinstance(policy, SchedPolicy) \
            or policy in ("dlbc", "lc", "wdlbc")
        assert prefill_mode in ("chunked", "whole"), prefill_mode
        if cfg.family in ("ssm", "hybrid"):
            # The per-slot cache index isolates attention KV across a
            # refill, but SSM/hybrid recurrent state is not position-
            # indexed: a refilled slot would consume the previous
            # occupant's conv/SSM state.  Refuse loudly rather than
            # decode corrupted tokens; serving recurrent families needs
            # a per-slot state reset on refill first.
            raise NotImplementedError(
                f"ContinuousBatcher does not support recurrent cache "
                f"families yet (family={cfg.family!r}): slot refill "
                f"would leak SSM state between requests")
        self.cfg = cfg
        self.params = params
        #: where the cache lives and the launches run (None = the card)
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.cache_len = cache_len
        #: static width of the batched prefill launch buffer — every
        #: chunk pads to this, which is what keeps chunked prefill
        #: bitwise equal to whole-prompt prefill (one compiled shape)
        self.prefill_chunk = max(1, int(prefill_chunk))
        #: "chunked" interleaves DLBC-planned chunks with decode steps;
        #: "whole" drains a request's entire prefill in its placement
        #: step (the unchunked baseline arm the adversary bench compares
        #: against)
        self.prefill_mode = prefill_mode
        #: per-request containment budget: a poisoned request (one that
        #: raises mid-serve) is requeued until it has been admitted
        #: ``retry.attempts`` times, then counted ``failed`` — its slot
        #: frees either way, so one tenant's poison never stalls another
        #: tenant's decode
        self.retry = retry if retry is not None else RetryPolicy(attempts=3)
        #: per-tenant SLO burn-rate monitor (repro.obs.monitor): fed once
        #: per step; ``None`` costs one attribute read per step
        self.monitor = monitor
        #: tenant → SLO deadline in decode steps (0/absent = none);
        #: merged with any ``TenantQueue.slo_steps`` set on the registry
        self.slos: Dict[str, int] = dict(slos or {})
        self.sched = SlotExecutor(n_slots, policy=policy)
        self.policy = self.sched.policy.name
        # tenant mode: explicit weights, or any weighted-refill policy
        self.registry: Optional[TenantRegistry] = None
        if tenants is not None \
                or isinstance(self.sched.policy, WeightedRefillPolicy):
            self.registry = TenantRegistry(tenants or {"default": 1.0})
            # resolve the refill wrapper NOW so an invalid base policy
            # (escape-join) fails at construction, not mid-run
            self.sched.weighted_policy()
            if not isinstance(self.sched.policy, WeightedRefillPolicy):
                # refill wraps the base policy in the deficit round-robin;
                # label the run accordingly ("wdlbc", "wlc", ...)
                self.policy = f"w{self.policy}"
        if self.registry is not None:
            # mirror explicit SLOs onto the tenant queues so the two
            # spellings (slos= kwarg, TenantQueue.slo_steps) agree
            for name, slo in self.slos.items():
                try:
                    self.registry.get(name).slo_steps = int(slo)
                except KeyError:
                    pass
        self.cache = MDL.init_cache(cfg, n_slots, cache_len,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        #: one FinishScope per in-flight request, spanning all its
        #: prefill chunks; joined exactly once at completion (AFE)
        self.slot_scope: List[Optional[FinishScope]] = [None] * n_slots
        #: slots whose prompt prefix is still being written (slot →
        #: prefill progress); a slot decodes only once it leaves here
        self._prefilling: Dict[int, _PrefillState] = {}
        self.queue: List[Request] = []   # single-queue (anonymous) mode
        self.stats = ServeStats()
        self.tenant_stats: Dict[str, ServeStats] = {}
        if self.registry is not None:
            for name in self.registry.names():
                self.tenant_stats[name] = ServeStats()
        #: admission trace: (step, slot, rid, tenant) per placement — the
        #: golden-file surface of the regression tests
        self.admissions: List[Tuple[int, int, int, str]] = []
        #: virtual clock in slot-step token units (decodes cost 1, a
        #: prefill round costs its largest chunk) — the time base of the
        #: decode-cost SLO surface
        self.vtime = 0

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """A COPY of host state for a launch: the loop mutates
        ``slot_pos`` right after the launch, so the launch must never
        alias it (``torch.tensor`` copies; ``from_numpy`` would not)."""
        return torch.tensor(a, dtype=torch.int64, device=self.device)

    # -- admission (DLBC vs LC vs weighted-DLBC) -----------------------------

    def submit(self, req: Request, tenant: Optional[str] = None):
        """Queue a request.  ``tenant`` overrides ``req.tenant``; in
        single-queue mode tenant labels are carried but not scheduled on.

        Validates the prompt here, at the boundary: an empty prompt used
        to crash deep in ``step()`` (``tokens[-1]`` IndexError) and
        out-of-vocab ids used to be silently wrapped ``% vocab`` —
        both now fail loudly at submission."""
        if tenant is not None:
            req.tenant = tenant
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt — decode needs at "
                f"least one token to feed the first step")
        bad = [int(t) for t in req.prompt
               if not 0 <= int(t) < self.cfg.vocab]
        if bad:
            raise ValueError(
                f"request {req.rid}: prompt ids {bad[:4]} outside "
                f"[0, {self.cfg.vocab}) — out-of-vocab ids are not "
                f"silently remapped")
        if len(req.prompt) > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot fit cache_len={self.cache_len}")
        if len(req.prompt) > 1 and (self.cfg.sliding_window > 0
                                    or self.cfg.family not in
                                    ("dense", "moe")):
            raise NotImplementedError(
                f"span prefill needs a full position-indexed KV cache "
                f"(dense/moe, no sliding window); "
                f"family={self.cfg.family!r} "
                f"sliding_window={self.cfg.sliding_window} is limited "
                f"to single-token prompts")
        if self.registry is not None:
            self.registry.submit(req, req.tenant)
            if req.tenant not in self.tenant_stats:
                # Backfill the denominators: a tenant first seen mid-run
                # starts from the GLOBAL step/slot-step counts, so its
                # utilization shares the same denominator as tenants
                # registered at step 0 (conservation invariant asserted
                # in test_tenancy_property).
                self.tenant_stats[req.tenant] = ServeStats(
                    steps=self.stats.steps,
                    total_slot_steps=self.stats.total_slot_steps,
                    first_step=self.stats.steps)
        else:
            self.queue.append(req)

    def queued(self) -> int:
        return (self.registry.total_queued() if self.registry is not None
                else len(self.queue))

    def _admit(self, now: int):
        # Delegated to the shared policy engine: DLBC fills every idle
        # slot at every step; LC only starts a full batch together; the
        # weighted deficit-round-robin arbitrates across tenant queues.
        backlog = self.registry if self.registry is not None else self.queue
        for slot, req in self.sched.refill(self.slot_req, backlog):
            self._place(slot, req, now)

    def _place(self, slot: int, req: Request, now: int):
        req.start_step = now
        wait = now - req.arrive_step
        self.stats.queue_waits.append(wait)
        if self.registry is not None:
            self.tenant_stats[req.tenant].queue_waits.append(wait)
        self.admissions.append((now, slot, req.rid, req.tenant))
        self.slot_req[slot] = req
        # Real prefill: prompt tokens 0..L-2 are written into the KV
        # cache by span-prefill chunks (interleaved with decode steps by
        # the policy's chunk arithmetic); decode then starts from the
        # LAST prompt token at position L-1.
        self.slot_pos[slot] = 0
        req.tokens = list(req.prompt)
        prefix = req.prompt[:-1]
        # One FinishScope per request over ONE latch covering every
        # prefill chunk (AFE: chunks discharge the latch, the scope is
        # joined once at completion).  telemetry=None — the request's
        # single counted join stays sched.complete()'s.
        scope = FinishScope()
        latch = RangeLatch(len(prefix))
        scope.add([latch])
        self.slot_scope[slot] = scope
        if prefix:
            self._prefilling[slot] = _PrefillState(prefix, latch)

    # -- per-request containment (faults, retries, SLO deadlines) ------------

    def _slo_of(self, tenant: str) -> int:
        """Deadline in decode steps for ``tenant`` (0 = none): the
        explicit ``slos=`` map wins, else the tenant queue's
        ``slo_steps``."""
        if tenant in self.slos:
            return int(self.slos[tenant])
        if self.registry is not None:
            try:
                return int(self.registry.get(tenant).slo_steps)
            except KeyError:
                return 0
        return 0

    def _join_timeout_s(self, tenant: str) -> Optional[float]:
        """Wall bound for the request's ONE scope join, derived from the
        tenant SLO (1 ms of wall time per SLO step — generous, since the
        prefill latch discharges in-step; ``None`` = no SLO, block)."""
        slo = self._slo_of(tenant)
        return None if slo <= 0 else max(1e-3, 1e-3 * slo)

    def _release_slot(self, i: int):
        """Free slot ``i`` without recording a completion latency: drop
        any prefill progress, count the join via ``sched.complete`` (so
        spawns == joins survives failure paths), and clear the slot."""
        self._prefilling.pop(i, None)
        self.sched.complete(slot=i)
        self.slot_req[i] = None
        self.slot_pos[i] = 0

    def _fail_request(self, i: int, now: int):
        """Contain a poisoned request in slot ``i``: record the error,
        free the slot (neighbours keep decoding), then either requeue it
        (within the retry budget) or count it ``failed``.  Never raises —
        one tenant's poison must not take the serving loop down."""
        r = self.slot_req[i]
        self.sched.telemetry.record_error("serve.request",
                                          tb=traceback.format_exc())
        obs.instant("sched", "error", args={"site": "serve.request"})
        scope = self.slot_scope[i]
        if scope is not None:
            # typed, non-raising join: the slot must free regardless of
            # what the scope collected
            scope.wait(timeout=self._join_timeout_s(r.tenant))
            self.slot_scope[i] = None
        self._release_slot(i)
        ts = self.tenant_stats.get(r.tenant)
        if r.attempts + 1 < self.retry.attempts:
            r.attempts += 1
            self.sched.telemetry.record_retry("serve.request")
            obs.instant("sched", "retry", args={"site": "serve.request"})
            r.arrive_step = now
            r.start_step = None
            r.done_step = None
            r.tokens = []
            if self.registry is not None:
                self.registry.submit(r, r.tenant)
            else:
                self.queue.append(r)
        else:
            self.stats.failed += 1
            if ts is not None:
                ts.failed += 1

    def _expire_request(self, i: int, now: int):
        """Evict the request in slot ``i`` past its tenant SLO deadline:
        the slot frees for queued work; the eviction is counted
        ``expired`` (apart from ``failed`` — nothing raised)."""
        r = self.slot_req[i]
        scope = self.slot_scope[i]
        if scope is not None:
            scope.wait(timeout=self._join_timeout_s(r.tenant))
            self.slot_scope[i] = None
        self._release_slot(i)
        self.stats.expired += 1
        ts = self.tenant_stats.get(r.tenant)
        if ts is not None:
            ts.expired += 1

    # -- chunked prefill ------------------------------------------------------

    def _prefill_phase(self) -> int:
        """Run prefill chunks for every prefilling slot (one batched
        ``prefill_step`` launch per round; rows of non-prefilling slots
        are inert via ``count == 0``).  Chunk lengths come from the
        policy's Fig. 6 arithmetic against the number of DECODING slots,
        re-probed every step; ``prefill_mode="whole"`` instead drains
        each prefill completely in this one step (the unchunked
        baseline).  Returns the phase's cost in token units (the largest
        chunk of each round, summed over rounds)."""
        n_decoding = sum(1 for i, r in enumerate(self.slot_req)
                         if r is not None and i not in self._prefilling)
        cost = 0
        while self._prefilling:
            chunk_of: Dict[int, int] = {}
            for i, st in self._prefilling.items():
                rem = len(st.tokens) - st.cursor
                if self.prefill_mode == "whole":
                    c = min(rem, self.prefill_chunk)
                else:
                    c = self.sched.policy.prefill_chunk_len(
                        rem, n_decoding, self.prefill_chunk)
                chunk_of[i] = max(1, min(int(c), rem, self.prefill_chunk))
            tokens = np.zeros((self.n_slots, self.prefill_chunk), np.int32)
            counts = np.zeros(self.n_slots, np.int32)
            for i, c in chunk_of.items():
                st = self._prefilling[i]
                tokens[i, :c] = st.tokens[st.cursor:st.cursor + c]
                counts[i] = c
            with obs.trace_span("serve", "prefill_chunk",
                                {"slots": len(chunk_of),
                                 "tokens": int(sum(chunk_of.values()))}
                                if obs.enabled() else None):
                _, self.cache = MDL.prefill_step(
                    self.params, self.cfg, self.cache,
                    {"tokens": self._on_device(tokens),
                     "cache_index": self._on_device(self.slot_pos),
                     "count": self._on_device(counts)})
            cost += max(chunk_of.values())
            for i, c in chunk_of.items():
                st = self._prefilling[i]
                st.cursor += c
                self.slot_pos[i] += c
                st.latch.discharge(c)
                self.sched.prefill(i, c)
                if st.cursor >= len(st.tokens):
                    # prefix complete: the slot joins decode THIS step
                    del self._prefilling[i]
            if self.prefill_mode != "whole":
                break  # chunked: one round per step, re-probe next step
        return cost

    # -- one decode step across all slots ------------------------------------

    def step(self, now: int):
        # obs phases (cat="serve"): refill → prefill_chunk* → decode →
        # complete, so a trace shows where a step's wall time goes
        # (admission arithmetic vs span prefill vs device step vs
        # completion bookkeeping) and slot occupancy can be read against
        # the admit/join/prefill_chunk instants.
        with obs.trace_span("serve", "refill"):
            self._admit(now)
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.stats.total_slot_steps += self.n_slots
        self.stats.busy_slot_steps += len(active)
        self.stats.steps += 1
        for st in self.tenant_stats.values():
            st.total_slot_steps += self.n_slots
            st.steps += 1
        # slot-share accounting off the executor's tenant occupancy map
        # (set at refill, cleared at complete)
        for name, n_busy in self.sched.tenant_busy_slots().items():
            self.tenant_stats[name].busy_slot_steps += n_busy
        # SLO expiry: a request still in-slot ``slo_steps`` after arrival
        # is evicted NOW so its slot refills next step — a stale request
        # cannot hold a slot past its tenant's deadline
        expired_any = False
        for i in active:
            r = self.slot_req[i]
            slo = self._slo_of(r.tenant)
            if slo > 0 and now - r.arrive_step >= slo:
                self._expire_request(i, now)
                expired_any = True
        if expired_any:
            active = [i for i, r in enumerate(self.slot_req)
                      if r is not None]
        if not active:
            self.vtime += 1
            self._post_step(now, 0)
            return
        prefill_cost = 0
        if self._prefilling:
            prefill_cost = self._prefill_phase()
        decoding = [i for i in active if i not in self._prefilling]
        step_cost = prefill_cost + (1 if decoding else 0)
        if decoding:
            with obs.trace_span("serve", "decode",
                                {"active": len(decoding)} if obs.enabled()
                                else None):
                tokens = np.zeros((self.n_slots, 1), np.int32)
                for i in decoding:
                    tokens[i, 0] = self.slot_req[i].tokens[-1]
                # Per-slot cache positions: each slot writes/attends at
                # ITS OWN index, so a freshly refilled slot is isolated
                # from a neighbour deep into its sequence
                # (refill-mid-decode safety).
                cache_index = self._on_device(self.slot_pos)
                logits, self.cache = MDL.decode_step(
                    self.params, self.cfg, self.cache,
                    {"tokens": self._on_device(tokens),
                     "cache_index": cache_index})
                # argmax over the REAL vocab: the padded tail rows of the
                # lm_head are arbitrary init values, and generated ids
                # must stay submittable (no silent % vocab anywhere).
                # One device→host copy per step.
                nxt = torch.argmax(logits[:, :self.cfg.vocab],
                                   dim=-1).cpu().numpy()
        with obs.trace_span("serve", "complete"):
            plan = faults.active()
            for i in decoding:
                r = self.slot_req[i]
                if plan is not None:
                    # poison hook: an injected fault on this request is
                    # CONTAINED — error recorded, slot freed, request
                    # requeued or failed; the loop moves to the next slot
                    try:
                        plan.poke("serve.request")
                    except Exception:
                        self._fail_request(i, now)
                        continue
                r.tokens.append(int(nxt[i]))
                self.slot_pos[i] += 1
                # per-token decode latency in token units: 1 for the
                # decode plus whatever prefill work shared the step
                self.stats.decode_step_costs.append(step_cost)
                ts = self.tenant_stats.get(r.tenant)
                if ts is not None:
                    ts.decode_step_costs.append(step_cost)
                produced = len(r.tokens) - len(r.prompt)
                done = produced >= r.max_new
                trunc = (not done) and self.slot_pos[i] >= self.cache_len - 1
                if done or trunc:
                    scope, self.slot_scope[i] = self.slot_scope[i], None
                    ok = True
                    if scope is not None:
                        # AFE: the request's ONE join point — waits the
                        # latch spanning every prefill chunk (already
                        # discharged in-step), never one join per chunk.
                        # The typed wait (deadline from the tenant SLO)
                        # distinguishes "timed out" from "done with
                        # failures"; either way the slot frees and the
                        # request is contained as failed rather than
                        # crashing the serving loop.
                        out = scope.wait(
                            timeout=self._join_timeout_s(r.tenant))
                        if out.status != "done":
                            ok = False
                            tb = out.errors[0].tb if out.errors else None
                            self.sched.telemetry.record_error(
                                "serve.request", tb=tb)
                            obs.instant("sched", "error",
                                        args={"site": "serve.request"})
                            self.stats.failed += 1
                            if ts is not None:
                                ts.failed += 1
                    if ok:
                        if trunc:
                            # cache-bound kill: count it apart from
                            # normal completions so p99 gates can't be
                            # satisfied by silently cutting sequences
                            # short
                            self.stats.truncated += 1
                            if ts is not None:
                                ts.truncated += 1
                        r.done_step = now
                        # latencies live in ServeStats (the serving-
                        # facing record); telemetry only counts the join
                        # so Fig. 10 comparisons hold
                        lat = now - r.arrive_step
                        self.stats.latencies.append(lat)
                        if ts is not None:
                            ts.latencies.append(lat)
                    self.sched.complete(slot=i)
                    self.slot_req[i] = None
                    self.slot_pos[i] = 0
        self.vtime += max(1, step_cost)
        self._post_step(now, step_cost)

    def _post_step(self, now: int, step_cost: int):
        """Once per step: feed the always-on metrics plane and (when
        attached) the per-tenant SLO burn-rate monitor."""
        _MX_SERVE_STEPS.inc()
        _MX_QUEUE_DEPTH.set(self.queued())
        if step_cost:
            _MX_STEP_COST.set(step_cost)
        if self.monitor is not None:
            self.monitor.observe(self, now)

    # -- driving --------------------------------------------------------------

    def slot_shares(self) -> Dict[str, float]:
        """Fraction of occupied slot-time each tenant received — compare
        against the weight shares for the isolation claim."""
        busy = max(1, self.stats.busy_slot_steps)
        return {name: st.busy_slot_steps / busy
                for name, st in sorted(self.tenant_stats.items())}

    def run(self, requests: List[Request], max_steps: int = 10_000):
        """Drive the clock, injecting each request at its ``arrive_step``
        (stable order for simultaneous arrivals)."""
        pending = sorted(requests, key=lambda r: r.arrive_step)
        now, nxt = 0, 0
        while (nxt < len(pending) or self.queued()
               or any(r is not None for r in self.slot_req)) \
                and now < max_steps:
            while nxt < len(pending) and pending[nxt].arrive_step <= now:
                self.submit(pending[nxt])
                nxt += 1
            self.step(now)
            now += 1
        return self.stats
