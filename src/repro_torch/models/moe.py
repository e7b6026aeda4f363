"""Mixture-of-Experts with DLBC-balanced dispatch.

Port of ``repro/models/moe.py``:

* **LC dispatch** (``moe_dispatch="lc"``) — static GShard top-k with a
  fixed per-expert capacity; over-capacity (token, choice) pairs are
  dropped.
* **DLBC dispatch** (``moe_dispatch="dlbc"``) — round 1 fills the
  balanced capacity; overflow pairs re-route once to their best open
  expert against the residual capacity (round 2).

Admission is decided by
:class:`repro_torch.sched.capacity.ExpertCapacityProvider`; the
dispatch/FFN/combine mechanics are in
:mod:`repro_torch.kernels.moe_dispatch.ops`, whose SwiGLU expert FFN
runs the grouped-matmul kernel by default.  A config with
``expert_parallel`` under a mesh whose expert axis divides E takes the
expert-parallel round instead (:mod:`repro_torch.ep`), differentiable,
over the expert group the caller passes (``ep``) or, without it, the
current mesh's.

On a ``"model"`` mesh axis of ``m`` ranks (``tp``), routing, capacity and
the DLBC re-route run whole and alike on every rank (the router is
replicated, so every rank takes the same decisions); where ``m`` divides
E each rank runs its ``E/m`` experts (the reference's E-over-model spec),
else every expert at ``d_ff/m``; the ranks' partial sums are then
all-reduced.  Beside an expert axis that takes E the EP round runs inside
that region, each model rank with the ``d_ff/m`` slice of its expert
rank's ``E/S`` experts.  The gates and the dispatched tokens enter the
tensor-parallel region, so their gradients are summed over the ranks.
With sequence parallelism (``sp``) the layer's input is the whole token
set gathered from the model ranks' sequence blocks: routing, capacity
and the re-route read every token, as in the reference, so the drops are
the reference's (routing a block alone would not be), and the output
leaves by a reduce-scatter onto this rank's block (the EP round's whole
result by a slice).

On a data axis of ``D`` ranks (``dp``) each rank routes its rows of the
batch, but capacity and slot positions are the whole batch's, as in the
reference's jitted step, where the batch is one global array: the ranks'
per-(choice, expert) pair counts are all-gathered once per admission
round (:func:`_dp_offsets`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.comm import copy_to_tp, enter_tp, expert_comm, leave_tp
from ..distributed.sharding import current_mesh
from ..kernels.moe_dispatch.ops import dispatch_combine
from ..sched import ExpertCapacityProvider
from .layers import _MetaGenerator, _norm_init


def moe_shapes(cfg, dtype) -> dict:
    return moe_init(_MetaGenerator(), cfg, dtype)


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    """Router in fp32, experts in ``dtype`` (the reference's layouts)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _norm_init(gen, (d, E), d ** -0.5, torch.float32),
        "w1": _norm_init(gen, (E, d, f), d ** -0.5, dtype),
        "w3": _norm_init(gen, (E, d, f), d ** -0.5, dtype),
        "w2": _norm_init(gen, (E, f, d), f ** -0.5, dtype),
    }


def capacity(T: int, E: int, top_k: int, cf: float) -> int:
    c = int(math.ceil(T * top_k / E * cf))
    return max(8, ((c + 7) // 8) * 8)  # pad to 8, as the reference does


def _positions_in_expert(expert_ids: torch.Tensor, E: int,
                         base: torch.Tensor = None) -> torch.Tensor:
    """Running slot index of each (token, choice) within its expert,
    counted choice-major (all k=0 first) so primary choices win slots.
    ``base``: (E,) pre-occupied slots per expert (round 2), or (K, E)
    slots added per (choice, expert) (:func:`_dp_offsets`)."""
    T, K = expert_ids.shape
    flat = expert_ids.t().reshape(-1)                  # choice-major (K*T,)
    # (E, K*T) one-hot, counted along its contiguous last dim: the scan
    # over the first dim of a (K*T, E) int64 one-hot is a slow CUDA kernel
    onehot = flat[None, :] == torch.arange(E, device=flat.device)[:, None]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 0, flat[None, :])[0].long()
    if base is not None and base.ndim == 2:
        choice = torch.arange(K, device=flat.device).repeat_interleave(T)
        pos = pos + base.reshape(-1)[choice * E + flat]
    elif base is not None:
        pos = pos + base[flat]
    return pos.reshape(K, T).t()                       # (T, K)


def _choice_counts(expert_ids: torch.Tensor, E: int) -> torch.Tensor:
    """(K, E) int32: how many of the pairs of each choice went to each
    expert."""
    T, K = expert_ids.shape
    out = torch.zeros((K, E), dtype=torch.int32, device=expert_ids.device)
    return out.scatter_add_(1, expert_ids.t().long(), torch.ones(
        (K, T), dtype=torch.int32, device=expert_ids.device))


def _dp_offsets(counts: torch.Tensor, dp):
    """The whole data-parallel batch's view of this rank's (K, E) pair
    ``counts`` (:func:`_choice_counts`): one all-gather over ``dp``'s
    ranks.  Rank ``r`` holds rows ``[r·T, (r+1)·T)`` of the batch, so a
    pair (choice ``k``, expert ``e``) of it sits, choice-major over the
    whole batch, after every rank's pairs of earlier choices and the
    pairs of choice ``k`` on ranks before ``r``.  Returns ``(offset,
    total)``: the (K, E) slots to add to this rank's choice-major
    positions, and the whole batch's (K, E) counts."""
    every = dp.all_gather(counts[None])                # (D, K, E)
    total = every.sum(0)
    before = torch.cumsum(total, 0) - total + every[:dp.rank].sum(0) \
        - (torch.cumsum(counts, 0) - counts)
    return before, total


def _expert_load(expert_ids: torch.Tensor, mask: torch.Tensor, E: int):
    flat = expert_ids.reshape(-1)
    return torch.sum(F.one_hot(flat, E) * mask.reshape(-1)[:, None], dim=0)


def dlbc_reroute(ids, gates, probs, pos1, keep1, load, provider,
                 n_groups: int, expert_open, group_of=None, dp=None,
                 with_counts: bool = False):
    """The DLBC round-2 re-route (a "group" is an expert here).

    Overflow (token, choice) pairs re-route once to the token's best
    expert among ``expert_open`` (the (E,) availability mask from the
    provider's residual), take positions after the ``load`` already
    admitted per group, and are re-admitted against the same provider.
    Returns ``(ids_f, group_f, pos_f, keep, gates_f, overflow)`` —
    rerouted pairs weighted by the probability of the expert that serves
    them.  ``dp`` (a data-axis ``Collectives`` of size > 1): ``load`` and
    ``expert_open`` are the whole batch's, and the overflow pairs take
    their positions among every data rank's (one all-gather of their
    ``(K, n_groups + 1)`` counts).  ``with_counts`` appends those counts
    (the whole batch's), the last group being the pairs not re-routed."""
    group_of = group_of or (lambda i: i)
    overflow = ~keep1                                  # (T, K)
    avail = probs * expert_open[None, :].to(probs.dtype)
    alt_ids = torch.argmax(avail, dim=-1)              # first maximum
    ids2 = torch.where(overflow, alt_ids[:, None], ids)
    group2 = group_of(ids2)
    grouped = torch.where(overflow, group2, n_groups)  # only overflow counts
    base = torch.cat([load, torch.zeros((1,), dtype=load.dtype,
                                        device=load.device)])
    counts = None
    if dp is not None or with_counts:
        counts = _choice_counts(grouped, n_groups + 1)
    if dp is not None:
        offset, counts = _dp_offsets(counts, dp)
        base = base[None, :] + offset
    pos2 = _positions_in_expert(grouped, n_groups + 1, base=base)
    ids_f = torch.where(overflow, ids2, ids)
    group_f = torch.where(overflow, group2, group_of(ids))
    pos_f = torch.where(overflow, pos2, pos1)
    keep = provider.admit_mask(pos_f)
    alt_gate = torch.gather(probs, -1, ids_f).to(gates.dtype)
    gates_f = torch.where(overflow, alt_gate, gates)
    out = (ids_f, group_f, pos_f, keep, gates_f, overflow)
    return out + (counts,) if with_counts else out


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x: (T, d) → (gates (T,K) fp32, expert_ids (T,K) int64, probs).

    Top-k by a stable descending sort: on equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` orders ties
    (``torch.topk`` leaves the tie order unspecified)."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def moe_apply(p: dict, cfg, x: torch.Tensor,
              return_stats: bool = False, use_kernel: bool = True, tp=None,
              ep=None, sp: bool = False, dp=None):
    """x: (B, S, d) or (T, d).  Dispatch per ``cfg.moe_dispatch``; the
    SwiGLU expert FFN runs the grouped-matmul kernel unless
    ``use_kernel=False`` (the reference's einsum path).  With ``tp`` (a
    model-axis ``Collectives``) ``p`` holds this rank's compute shards of
    the experts.  With ``ep`` (an expert-axis ``Collectives``, as
    :func:`repro_torch.distributed.comm.expert_comm` gives it) the layer
    takes the EP round over ``ep``'s ranks, ``p``'s experts whole or this
    rank's ``E/S``; without it, a config with ``expert_parallel`` takes
    the round over the current mesh's expert axis.  With both (the
    ``(expert, data, model)`` layout) the round runs inside the
    tensor-parallel region over ``tp``, ``p``'s experts this rank's ``E/S``
    × ``d_ff/m`` (or whole, sliced).
    The caller passes ``ep`` where the mesh context may be unset: a
    ``remat`` recompute runs on the autograd engine's thread.  ``sp``:
    ``x`` (B, S, d) is the whole sequence gathered from the model ranks'
    blocks, and the result is this rank's block (B, S/m, d).  Routing and
    the EP round compute alike on every model rank, so they read ``x``
    with only this rank's block of its gradient passed back
    (``keep_block_grad``); the experts' partial products are
    reduce-scattered, the round's whole result sliced.

    ``dp`` (a data-axis ``Collectives``): ``x`` is data rank ``r``'s rows
    ``[r·T, (r+1)·T)`` of a batch of ``D·T`` tokens, which the reference
    routes as one array.  The EP round gathers every data rank's rows and
    runs on the whole batch (``ep.dispatch.ep_dispatch_combine``).
    Otherwise, where ``D > 1`` capacity is sized over ``D·T`` tokens and
    every pair takes its position among the whole batch's (choice-major,
    then rank by rank), from the ``(K, E)`` pair counts of every rank,
    all-gathered once per round: one all-gather for ``lc``, two for
    ``dlbc`` (its round-1 load and residual come from the first).
    ``return_stats`` then reports the whole batch's drops."""
    orig_shape = x.shape
    # routing and the EP round compute alike on every model rank
    xr = enter_tp(x, tp, split=False, gathered=sp).reshape(-1, x.shape[-1])
    x = x.reshape(-1, x.shape[-1])
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if ep is None:
        ep = expert_comm(current_mesh(), cfg)
    if dp is not None and dp.size == 1:
        dp = None
    if ep is not None:
        # Expert-parallel all-to-all dispatch (repro_torch.ep) over the
        # whole batch's rows (every data rank's, gathered over ``dp``)
        from ..ep.dispatch import ep_dispatch_combine
        out = ep_dispatch_combine(p, cfg, xr, comm=ep, tp=tp, dp=dp,
                                  use_kernel=use_kernel,
                                  return_stats=return_stats)
        y, ep_stats = out if return_stats else (out, None)
        y = leave_tp(y.reshape(orig_shape), tp, split=False, sp=sp)
        return (y, ep_stats) if return_stats else y
    D = dp.size if dp is not None else 1
    C = capacity(D * T, E, K, cfg.moe_capacity_factor)
    cap = ExpertCapacityProvider(E, C)
    gates, ids, probs = route(xr, p["router"], K)
    rounds = 1
    experts = None
    if tp is not None and p["w1"].shape[-3] < E:
        n = p["w1"].shape[-3]
        experts = (tp.rank * n, (tp.rank + 1) * n)

    def run(gates_, ids_, pos_, keep_):
        return dispatch_combine(
            enter_tp(x, tp, gathered=sp), copy_to_tp(gates_, tp), ids_, pos_,
            keep_, E, C, p, cfg.act, use_kernel=use_kernel, experts=experts)

    base = total = None
    if dp is not None:
        base, total = _dp_offsets(_choice_counts(ids, E), dp)
    pos1 = _positions_in_expert(ids, E, base=base)
    keep1 = cap.admit_mask(pos1)
    if cfg.moe_dispatch == "lc":
        keep = keep1
        y = run(gates, ids, pos1, keep1)
    else:
        rounds = 2
        if total is None:
            load = _expert_load(ids, keep1, E)      # (E,) used slots
        else:
            load = torch.clamp(total.sum(0), max=C)
        resid = cap.residual(load)                  # idle capacity
        out = dlbc_reroute(ids, gates, probs, pos1, keep1, load, cap, E,
                           expert_open=resid > 0, dp=dp,
                           with_counts=return_stats and dp is not None)
        ids_final, _, pos_final, keep, gates_final, _ = out[:6]
        y = run(gates_final, ids_final, pos_final, keep)
    y = leave_tp(y.reshape(orig_shape), tp, sp=sp)
    if return_stats:
        if dp is None:
            dropped = torch.sum(~keep)
        else:
            # the whole batch's: past C in each expert after round 1,
            # less what round 2 admitted of the re-routed pairs
            dropped = torch.clamp(total.sum(0) - C, min=0).sum()
            if rounds == 2:
                dropped = dropped - torch.minimum(out[6].sum(0)[:E],
                                                  resid).sum()
        return y, {"dropped_frac": dropped / (D * T * K),
                   "spawns": D * T * K - dropped,
                   "joins": 1, "rounds": rounds,
                   "total_slots": cap.total()}
    return y


def moe_ref(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity."""
    orig_shape = x.shape
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    gates, ids, _ = route(x, p["router"], cfg.top_k)
    outs = []
    for e in range(cfg.n_experts):
        if cfg.act == "swiglu":
            h = F.silu(x @ p["w1"][e]) * (x @ p["w3"][e])
        else:
            h = F.gelu(x @ p["w1"][e], approximate="tanh")
        outs.append(h @ p["w2"][e])
    dense = torch.stack(outs, dim=1)                           # (T, E, d)
    sel = torch.gather(dense, 1, ids[..., None].expand(-1, -1, dense.shape[-1]))
    return torch.einsum("tkd,tk->td", sel, gates.to(x.dtype)).reshape(
        orig_shape)
