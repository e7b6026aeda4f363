"""``ep_dispatch_combine`` — the expert-parallel dispatch round.

Port of ``repro/ep/dispatch.py`` onto ``torch.distributed``.  One round,
four legs, ONE join:

1. **Shard-local route** — each expert shard top-k routes its own slice
   of the tokens against the replicated router, then runs the DLBC lane
   admission: over-capacity residuals reassigned to an expert on a shard
   with idle lane capacity **before** the collective (the single-probe
   round-2 re-route of ``models.moe`` lifted from experts to expert
   shards; the host-side :func:`repro_torch.ep.plan.plan_exchange`
   re-probes to exhaustion, so its drop count lower-bounds this round's).
2. **Dispatch all-to-all** — capacity-padded lane buffers exchanged over
   the expert group (:func:`repro_torch.ep.collective.exchange`).
3. **Per-shard expert FFN** — received pairs admitted into the local
   ``(E/S, C, d)`` capacity buffers (the same
   :class:`~repro_torch.sched.capacity.ExpertCapacityProvider` arithmetic
   as the single-host path) and pushed through ``expert_ffn``: on the
   card, one ``moe_gmm`` launch per shard and round.
4. **Combine all-to-all** — expert outputs retrace the exchange home and
   gate-combine in token order.

The reference runs the legs inside one ``shard_map``; here each expert
shard is a process of the expert group.  Every rank is given the whole
``(T, d)`` token matrix (the reference's global array), takes its ``T/S``
rows and its ``E/S`` experts' weights, and the round ends with the
shards' outputs all-gathered back to ``(T, d)`` and their stats summed.

AFE is the synchronization story: the whole round is one bulk step with
a single logical barrier.  :func:`ep_round` runs each round under a DCAFE
:class:`~repro_torch.sched.executors.FinishScope`, so telemetry shows
exactly ``joins == rounds``.

Numerics: with ample capacity the result equals the single-host
``dispatch_combine``; under pressure the DLBC plan reassigns overflow
instead of dropping it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.comm import Collectives, mesh_group
from ..distributed.sharding import require_executable
from ..kernels.moe_dispatch.ops import (
    combine_tokens, dispatch_tokens, expert_ffn,
)
from ..models.moe import (
    _expert_load, _positions_in_expert, capacity, dlbc_reroute, route,
)
from ..obs import metrics as obs_metrics
from ..obs import monitor as obs_monitor
from ..obs import trace as obs
from ..sched import ExpertCapacityProvider, SchedTelemetry
from ..sched import faults
from ..sched.executors import FinishScope
from ..sched.faults import ShardLossError
from .collective import EXPERT_AXIS, exchange, expert_axis_size
from .plan import lane_capacity


def _ep_shard(x, router, w1, w3, w2, *, comm, E: int, S: int, K: int,
              C_lane: int, C_local: int, act: str, use_kernel: bool,
              impl: str, reassign: bool, dead_shards: tuple = ()):
    """One expert shard's slice of the dispatch round: ``x`` its
    ``(T/S, d)`` tokens, ``w1``/``w3``/``w2`` its ``E/S`` experts.

    Returns ``(y_local, stats_row)`` where ``stats_row`` is the shard's
    ``[sent, received, reassigned, admitted]`` counts.
    """
    Tl, d = x.shape
    E_local = E // S
    lane_cap = ExpertCapacityProvider(n_experts=S, slots_per_expert=C_lane)
    local_cap = ExpertCapacityProvider(n_experts=E_local,
                                       slots_per_expert=C_local)

    # --- leg 1: shard-local route + DLBC lane plan ----------------------
    gates, ids, probs = route(x, router, K)          # (Tl, K)
    dest = ids // E_local                            # destination shard
    pos = _positions_in_expert(dest, S)              # rank in my lane
    # A dead shard's lanes are CLOSED at the admission mask, so no pair is
    # packed toward it: under ``reassign`` the re-route moves those pairs
    # onto live shards with lane residual before the collective, under LC
    # they drop like any overflow.
    alive_v = torch.tensor([s not in dead_shards for s in range(S)],
                           device=x.device)
    keep1 = lane_cap.admit_mask(pos) & alive_v[dest]
    if reassign:
        # single-probe overflow reassignment: the single-host DLBC round 2
        # with expert shards as the groups
        lane_load = _expert_load(dest, keep1, S)     # (S,) kept per lane
        resid = lane_cap.residual(lane_load)
        ids_f, dest_f, pos_f, keep, gates_f, overflow = dlbc_reroute(
            ids, gates, probs, pos, keep1, lane_load, lane_cap, S,
            expert_open=torch.repeat_interleave((resid > 0) & alive_v,
                                                E_local),
            group_of=lambda i: i // E_local)
    else:
        # LC lane semantics: one static admission round, overflow dropped
        ids_f, dest_f, pos_f, keep, gates_f = ids, dest, pos, keep1, gates
        overflow = ~keep1

    # --- pack lanes + dispatch all-to-all -------------------------------
    slot = dest_f * C_lane + torch.clamp(pos_f, max=C_lane - 1)  # (Tl, K)
    # The local expert id rides the exchange as payload column d, encoded
    # +1 so an untouched row reads 0 ("empty"), so the dispatch leg stays
    # ONE all-to-all.  Kept slots are unique; a dropped pair's clamped
    # slot can coincide with a kept one's, so dropped pairs are written to
    # a spare row past the buffer, which is cut off.
    meta = (ids_f % E_local + 1).to(x.dtype)                   # (Tl, K)
    payload = torch.cat([x[:, None, :].expand(Tl, K, d), meta[..., None]],
                        dim=-1)
    target = torch.where(keep, slot, S * C_lane).reshape(-1)
    sendx = torch.zeros((S * C_lane + 1, d + 1), dtype=x.dtype,
                        device=x.device)
    sendx[target] = payload.reshape(Tl * K, d + 1)
    recv = exchange(sendx[:S * C_lane], S, comm=comm, impl=impl)
    recvx = recv[:, :d]
    recv_eid = recv[:, d].long() - 1                 # -1 = empty row

    # --- leg 3: local admission + expert FFN ----------------------------
    valid = recv_eid >= 0
    rids = torch.clamp(recv_eid, min=0)
    rpos = _positions_in_expert(
        torch.where(valid, recv_eid, E_local)[:, None], E_local + 1)[:, 0]
    keep_loc = (valid & local_cap.admit_mask(rpos))[:, None]
    buf, slot_loc = dispatch_tokens(recvx, keep_loc, rids[:, None],
                                    rpos[:, None], E_local, C_local)
    out = expert_ffn(buf, {"w1": w1, "w3": w3, "w2": w2}, act,
                     use_kernel=use_kernel)
    ones = torch.ones(keep_loc.shape, dtype=recvx.dtype, device=x.device)
    y_recv = combine_tokens(out, slot_loc, ones, keep_loc)   # (S·C_lane, d)

    # --- leg 4: combine all-to-all + gate-combine -----------------------
    # The exchange is its own inverse on lane layout: block i of y_recv
    # holds results for source i's lane, so one more exchange files each
    # shard's own lane results back under the slots it packed them from.
    backx = exchange(y_recv, S, comm=comm, impl=impl)
    gathered = backx[slot.reshape(-1)].reshape(Tl, K, d)
    w = (gates_f * keep).to(x.dtype)
    y = torch.einsum("tkd,tk->td", gathered, w)

    stats_row = torch.stack([
        torch.sum(keep), torch.sum(valid), torch.sum(overflow & keep),
        torch.sum(keep_loc)]).to(torch.int64)
    return y, stats_row


def ep_dispatch_combine(p: dict, cfg, x, *, mesh, use_kernel: bool = True,
                        impl: str = "all_to_all",
                        return_stats: bool = False,
                        dead_shards: tuple = (), comm=None):
    """Expert-parallel dispatch → FFN → combine over the ``expert`` axis.

    ``x`` is the flattened ``(T, d)`` token matrix, the same on every rank
    of the expert group; the result is too.  Requires ``T % S == 0 and E
    % S == 0`` for the expert axis's size ``S`` (``S = 1`` runs the round
    on one rank).  ``comm`` (a
    :class:`~repro_torch.distributed.comm.Collectives` over the expert
    group, made here when not given) issues and counts the collectives.

    ``dead_shards`` runs the round DEGRADED: the listed shards' lanes are
    closed at admission, so their traffic re-routes to live shards (DLBC)
    or drops (LC) before the collective — see :func:`ep_round` for the
    retry loop that discovers the dead set.
    """
    require_executable(mesh)
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S = expert_axis_size(mesh)
    if S < 1 or T % S or E % S:
        raise ValueError(
            f"EP dispatch needs an expert axis dividing T={T} and "
            f"E={E}; mesh axes {getattr(mesh, 'mesh_dim_names', None)}")
    dead_shards = tuple(sorted({int(s) for s in dead_shards}))
    if dead_shards:
        bad = [s for s in dead_shards if not 0 <= s < S]
        if bad:
            raise ValueError(f"dead_shards {bad} outside [0, {S})")
        if len(dead_shards) >= S:
            raise ValueError(
                f"all {S} shards dead — nothing left to degrade onto")
    C_lane = lane_capacity(T // S, K, S, cfg.moe_capacity_factor)
    # Per-expert capacity matches the single-host formula on the GLOBAL
    # token count, so admission (and numerics) line up shard-for-shard.
    C_local = capacity(T, E, K, cfg.moe_capacity_factor)
    if x.is_floating_point():
        # the expert-id metadata rides as a payload column, +1-encoded:
        # it must be exactly representable in the payload dtype
        max_exact = round(2 / torch.finfo(x.dtype).eps)
        if E // S + 1 > max_exact:
            raise ValueError(
                f"E/S + 1 = {E // S + 1} local expert ids do not fit "
                f"exactly in {x.dtype} (max {max_exact}); cast tokens "
                "to a wider dtype for EP dispatch")
    comm = comm or Collectives(mesh_group(mesh, EXPERT_AXIS))
    s, El, Tl = comm.rank, E // S, T // S
    experts = slice(s * El, (s + 1) * El)
    y, stats_row = _ep_shard(
        x[s * Tl:(s + 1) * Tl], p["router"].float(), p["w1"][experts],
        p["w3"][experts], p["w2"][experts], comm=comm, E=E, S=S, K=K,
        C_lane=C_lane, C_local=C_local, act=cfg.act, use_kernel=use_kernel,
        impl=impl,
        # "lc" keeps its static single-round semantics on the EP substrate
        # too (no reassignment), so the LC-vs-DLBC comparison holds
        reassign=cfg.moe_dispatch != "lc", dead_shards=dead_shards)
    y = comm.all_gather(y)
    if not return_stats:
        return y
    sent, received, reassigned, admitted = comm.all_reduce(stats_row)
    total_pairs = T * K
    stats = {
        # the shared moe_apply vocabulary (spawns + dropped == T·K):
        "dropped_frac": (total_pairs - admitted) / total_pairs,
        "spawns": admitted,
        "joins": 1,              # ONE barrier for the whole round (AFE)
        "rounds": 1,
        "total_slots": S * El * C_local,
        # the exchange vocabulary (SchedTelemetry.exchange):
        "sent": sent,
        "received": received,
        "reassigned": reassigned,
        "dropped": total_pairs - admitted,
        "n_shards": S,
        "lane_capacity": C_lane,
    }
    return y, stats


def ep_round(p: dict, cfg, x, *, mesh,
             telemetry: Optional[SchedTelemetry] = None,
             use_kernel: bool = True, impl: str = "all_to_all"):
    """One dispatch round under a DCAFE :class:`FinishScope`.

    The host-side entry for serving and benchmarks: runs the round, waits
    for the device (the scope exit IS the round's single barrier), and
    folds the exchange counts into ``telemetry`` — ``spawns`` advance by
    the admitted pairs, ``joins`` by exactly one, and
    ``telemetry.exchange`` by the sent/received/reassigned/dropped counts.
    Returns ``(y, stats)`` with host-int stats.

    Shard loss degrades, it does not abort: a
    :class:`~repro_torch.sched.faults.ShardLossError` (raised by the
    fault-injection hook before the round posts) adds the shard to the
    round's dead set, bumps the retry telemetry, and re-attempts with that
    shard's lanes closed.  Every rank of the expert group must see the
    same loss (the fault plan is seeded alike on every rank), since each
    attempt is a collective.  A degraded round that completes counts
    ``exchange.degraded_rounds``; losing the LAST live shard, or the same
    shard twice, re-raises.
    """
    telemetry = telemetry if telemetry is not None else SchedTelemetry()
    plan = faults.active()
    dead: set = set()
    S = expert_axis_size(mesh)
    comm = Collectives(mesh_group(mesh, EXPERT_AXIS))
    # obs round edges (cat="ep"): ``round_posted`` when the round's
    # collectives are launched, ``round_completed`` when its single
    # barrier lands.
    while True:
        try:
            if plan is not None:
                shard = plan.lost_shard("ep.round")
                if shard is not None:
                    raise ShardLossError(shard)
            with obs.trace_span("ep", "round"):
                with FinishScope(telemetry):
                    obs.instant("ep", "round_posted")
                    telemetry.record_exchange(posted=1)
                    with obs.trace_span("ep", "launch"):
                        y, stats = ep_dispatch_combine(
                            p, cfg, x, mesh=mesh, use_kernel=use_kernel,
                            impl=impl, return_stats=True,
                            dead_shards=tuple(sorted(dead)), comm=comm)
                    with obs.trace_span("ep", "barrier"):
                        if y.is_cuda:
                            torch.cuda.synchronize(y.device)
                    stats = {k: (float(v) if k == "dropped_frac"
                                 else int(v))
                             for k, v in stats.items()}
            break
        except ShardLossError as e:
            sh = int(getattr(e, "shard", -1))
            if sh in dead or len(dead) + 1 >= S:
                raise  # same shard twice, or no live shard left
            dead.add(sh)
            telemetry.record_retry("ep.round")
            obs.instant("sched", "retry", args={"site": "ep.round"})
    obs.instant("ep", "round_completed")
    with telemetry.lock:
        telemetry.spawns += stats["spawns"]
    obs.instant("sched", "spawn", n=stats["spawns"])
    telemetry.record_exchange(
        sent=stats["sent"], received=stats["received"],
        reassigned=stats["reassigned"], dropped=stats["dropped"],
        completed=1, degraded=1 if dead else 0)
    obs_metrics.counter("ep.rounds").inc()
    # scalar stats only: degraded is a 0/1 flag, dead_shards the count of
    # lanes closed this round
    stats["degraded"] = int(bool(dead))
    stats["dead_shards"] = len(dead)
    if dead:
        obs_metrics.counter("ep.degraded_rounds").inc()
        # flight-recorder trigger: the round COMPLETED, but it ran with
        # lanes closed — dump the window while the evidence is fresh
        obs_monitor.on_ep_degraded(dead)
    return y, stats
