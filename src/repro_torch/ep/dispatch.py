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
shards' outputs all-gathered back to ``(T, d)`` (and, when asked for,
their stats summed).  Beside a data axis (``dp=``) a rank holds only its
data rank's rows: they are all-gathered over the data ranks first, so the
round runs on the whole batch's ``T = D·T_local`` rows with lanes and
capacities over ``T``, as the reference's ``P("expert", None)`` hands
each expert shard ``T/S`` rows of the global array, and the rank keeps
its own rows of the result (the gather's backward is a slice: an output
row depends only on its own token once admission is fixed).  Each rank
then runs the expert FFN over ``D×`` the rows its data rank alone would
give it.  The round is differentiable, as the reference's
``shard_map`` is under ``jax.grad``: its collectives are the autograd
functions of :mod:`repro_torch.distributed.comm` (the exchanges run
again on the gradients, the token block's gradient is all-gathered, the
output gather's backward issues nothing) and, on the card, each shard's
expert FFN goes through ``moe_gmm``'s autograd function, so the backward
launches ``moe_gmm_bwd`` once per shard and round.

On the reference's ``(expert, data, model)`` production layout the
model ranks of one expert rank hold the same tokens and the same
replicated router, so they pack identical lanes, and each line of expert
ranks (one data and one model rank) runs its own exchanges.  The
reference gathers each expert rank's experts whole into its
``shard_map``; here each model rank computes with its ``d_ff/m`` slice
of them (the storage layout is the compute layout), and the lane
results are summed over the model ranks before the return exchange
(``tp=``).  Under sequence parallelism the round keeps this inside:
``models.moe.moe_apply`` hands it the token matrix gathered from the
model ranks' sequence blocks (the reference's ``shard_map`` takes ``x``
replicated over ``"model"``), only this rank's block of its gradient
passed back, and takes this rank's sequence block of the whole result.

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
import torch.nn.functional as F

from ..distributed.comm import (
    Collectives, copy_to_tp, gather_from_ep, mesh_group, reduce_from_tp,
    slice_to_ep,
)
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


def _ep_pack(x, router, *, E: int, S: int, K: int, C_lane: int,
             reassign: bool, dead_shards: tuple = (), tp=None):
    """Leg 1 of one expert shard: route its ``(T/S, d)`` tokens ``x``
    against the replicated ``router``, plan the lanes (DLBC reassignment
    under ``reassign``) and pack them.  With ``tp`` (the model ranks, each
    computing a d_ff slice of the experts) the packed tokens enter the
    tensor-parallel region: their gradient, partial on each model rank,
    is all-reduced over them; routing reads ``x`` as it is, since it runs
    whole and alike on every model rank.  Returns ``(sendx, plan)``:
    ``sendx`` the ``(S·C_lane, d + 1)`` lane buffer (block ``j`` for
    shard ``j``; column ``d`` the +1-encoded local expert id, which
    carries no gradient), ``plan`` what :func:`_ep_combine` needs."""
    Tl, d = x.shape
    E_local = E // S
    lane_cap = ExpertCapacityProvider(n_experts=S, slots_per_expert=C_lane)
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

    slot = dest_f * C_lane + torch.clamp(pos_f, max=C_lane - 1)  # (Tl, K)
    # The local expert id rides the exchange as payload column d, encoded
    # +1 so an untouched row reads 0 ("empty"), so the dispatch leg stays
    # ONE all-to-all.  Kept slots are unique; a dropped pair's clamped
    # slot can coincide with a kept one's, so dropped pairs are written to
    # a spare row past the buffer, which is cut off.
    meta = (ids_f % E_local + 1).to(x.dtype)                   # (Tl, K)
    payload = torch.cat([copy_to_tp(x, tp)[:, None, :].expand(Tl, K, d),
                         meta[..., None]], dim=-1)
    target = torch.where(keep, slot, S * C_lane).reshape(-1)
    sendx = torch.zeros((S * C_lane + 1, d + 1), dtype=x.dtype,
                        device=x.device)
    sendx[target] = payload.reshape(Tl * K, d + 1)
    return sendx[:S * C_lane], (slot, gates_f, keep, overflow)


def _ep_experts(recv, w1, w3, w2, *, C_local: int, act: str,
                use_kernel: bool):
    """Leg 3: admit the received rows into the local ``(E/S, C_local, d)``
    capacity buffers and run the expert FFN (``moe_gmm`` on the card).
    Returns ``(y_recv, valid, keep_loc)``: the results in lane layout,
    the rows that carried a pair and the pairs admitted."""
    d = recv.shape[1] - 1
    E_local = w1.shape[0]
    local_cap = ExpertCapacityProvider(n_experts=E_local,
                                       slots_per_expert=C_local)
    recvx = recv[:, :d]
    recv_eid = recv[:, d].detach().long() - 1        # -1 = empty row
    valid = recv_eid >= 0
    rids = torch.clamp(recv_eid, min=0)
    rpos = _positions_in_expert(
        torch.where(valid, recv_eid, E_local)[:, None], E_local + 1)[:, 0]
    keep_loc = (valid & local_cap.admit_mask(rpos))[:, None]
    buf, slot_loc = dispatch_tokens(recvx, keep_loc, rids[:, None],
                                    rpos[:, None], E_local, C_local)
    out = expert_ffn(buf, {"w1": w1, "w3": w3, "w2": w2}, act,
                     use_kernel=use_kernel)
    ones = torch.ones(keep_loc.shape, dtype=recvx.dtype, device=recv.device)
    return combine_tokens(out, slot_loc, ones, keep_loc), valid, keep_loc


def _ep_combine(backx, plan, dtype):
    """Leg 4's gate-combine: each pair's result, filed back under the slot
    it was packed from, weighted by its gate, summed in token order."""
    slot, gates_f, keep, _ = plan
    Tl, K = slot.shape
    gathered = backx[slot.reshape(-1)].reshape(Tl, K, backx.shape[1])
    return torch.einsum("tkd,tk->td", gathered, (gates_f * keep).to(dtype))


def _ep_shard(x, router, w1, w3, w2, *, comm, E: int, S: int, K: int,
              C_lane: int, C_local: int, act: str, use_kernel: bool,
              impl: str, reassign: bool, dead_shards: tuple = (), tp=None):
    """One expert shard's slice of the dispatch round: ``x`` its
    ``(T/S, d)`` tokens, ``w1``/``w3``/``w2`` its ``E/S`` experts (with
    ``tp``, this model rank's d_ff slice of them: the lane results are
    then partial sums, all-reduced over the model ranks before the
    return exchange, so the gates multiply whole values).

    Returns ``(y_local, stats_row)`` where ``stats_row`` is the shard's
    ``[sent, received, reassigned, admitted]`` counts.
    """
    sendx, plan = _ep_pack(x, router, E=E, S=S, K=K, C_lane=C_lane,
                           reassign=reassign, dead_shards=dead_shards, tp=tp)
    recv = exchange(sendx, S, comm=comm, impl=impl)
    y_recv, valid, keep_loc = _ep_experts(recv, w1, w3, w2, C_local=C_local,
                                          act=act, use_kernel=use_kernel)
    y_recv = reduce_from_tp(y_recv, tp)
    # The exchange is its own inverse on lane layout: block i of y_recv
    # holds results for source i's lane, so one more exchange files each
    # shard's own lane results back under the slots it packed them from.
    y = _ep_combine(exchange(y_recv, S, comm=comm, impl=impl), plan,
                    x.dtype)
    _, _, keep, overflow = plan
    stats_row = torch.stack([
        torch.sum(keep), torch.sum(valid), torch.sum(overflow & keep),
        torch.sum(keep_loc)]).to(torch.int64)
    return y, stats_row


def ep_dispatch_combine(p: dict, cfg, x, *, mesh=None,
                        use_kernel: bool = True, impl: str = "all_to_all",
                        return_stats: bool = False,
                        dead_shards: tuple = (), comm=None, tp=None,
                        dp=None):
    """Expert-parallel dispatch → FFN → combine over the ``expert`` axis.

    ``x`` is the flattened ``(T, d)`` token matrix, the same on every rank
    of the expert group; the result is too.  Requires ``E % S == 0`` for
    the expert axis's size ``S`` (``S = 1`` runs the round on one rank); a
    token count not divisible by ``S`` is zero-padded up to the next
    multiple and sliced back (``padded_tokens`` in the stats), as the
    reference's ``moe_apply`` pads.  ``dp`` (a data-axis ``Collectives``
    of ``D > 1`` ranks): ``x`` is data rank ``r``'s rows ``[r·T, (r+1)·T)``
    of a ``D·T``-row matrix; one all-gather over ``dp`` makes the whole
    matrix, the round runs on it (lanes and capacities over ``D·T``), and
    the result is this rank's rows (backward, the gather keeps this rank's
    block of the gradient and issues nothing).  ``comm`` (a
    :class:`~repro_torch.distributed.comm.Collectives` over the expert
    group) issues and counts the collectives; without it one is made over
    ``mesh``'s expert axis.  ``tp`` (a ``Collectives`` over the model
    ranks of a ``(expert, data, model)`` mesh, which hold the same tokens)
    runs the round inside the tensor-parallel region: each model rank
    computes its d_ff slice of its expert rank's ``E/S`` experts, and one
    all-reduce over the model ranks sums the lane results before the
    return exchange (and one sums the tokens' gradient backward).  ``p``'s
    expert weights are whole (E; this rank's ``E/S`` are sliced out), the
    rank's ``E/S``, or with ``tp`` the rank's ``E/S`` × ``d_ff/m`` (the
    training layout); whatever is whole is sliced.

    Differentiable: backward, the two exchanges run again on the
    gradients (``moe_gmm_bwd`` per shard in between on the card), the
    token block's gradient is all-gathered, and the router's gradient is
    this rank's partial sum (its tokens' share), left for the caller to
    sum over the expert group (the train step does, once per step).
    ``return_stats`` costs one more all-reduce (the stats' sums).

    ``dead_shards`` runs the round DEGRADED: the listed shards' lanes are
    closed at admission, so their traffic re-routes to live shards (DLBC)
    or drops (LC) before the collective — see :func:`ep_round` for the
    retry loop that discovers the dead set.
    """
    E, K = cfg.n_experts, cfg.top_k
    S = comm.size if comm is not None else expert_axis_size(mesh)
    if S < 1 or E % S:
        raise ValueError(
            f"EP dispatch needs an expert axis dividing E={E}; mesh axes "
            f"{getattr(mesh, 'mesh_dim_names', None)}")
    if dp is not None and dp.size == 1:
        dp = None
    rows = x.shape[0]
    if dp is not None:
        x = gather_from_ep(x, dp)          # every data rank's rows
    n_rows = x.shape[0]
    pad = (-n_rows) % S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    T, d = x.shape
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
    El = E // S
    n = p["w1"].shape[-3]
    if n not in (E, El):
        raise ValueError(f"expert weights hold {n} experts: neither E={E} "
                         f"nor this rank's E/S={El}")
    experts = slice(comm.rank * El, (comm.rank + 1) * El) if n != El \
        else slice(None)
    w1, w3, w2 = (p[k][experts] for k in ("w1", "w3", "w2"))
    m = tp.size if tp is not None else 1
    f = w1.shape[-1]
    if f not in (cfg.d_ff, cfg.d_ff // m):
        raise ValueError(f"expert weights of width {f}: neither d_ff="
                         f"{cfg.d_ff} nor this model rank's d_ff/m="
                         f"{cfg.d_ff // m}")
    if f != cfg.d_ff // m:
        fl = f // m
        cols = slice(tp.rank * fl, (tp.rank + 1) * fl)
        w1, w3, w2 = w1[..., cols], w3[..., cols], w2[..., cols, :]
    y, stats_row = _ep_shard(
        slice_to_ep(x, comm), p["router"].float(), w1, w3, w2, comm=comm,
        E=E, S=S, K=K,
        C_lane=C_lane, C_local=C_local, act=cfg.act, use_kernel=use_kernel,
        impl=impl,
        # "lc" keeps its static single-round semantics on the EP substrate
        # too (no reassignment), so the LC-vs-DLBC comparison holds
        reassign=cfg.moe_dispatch != "lc", dead_shards=dead_shards, tp=tp)
    y = gather_from_ep(y, comm)[:n_rows]
    if dp is not None:
        y = y[dp.rank * rows:(dp.rank + 1) * rows]
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
        "padded_tokens": pad,
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
