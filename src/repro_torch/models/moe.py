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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.comm import copy_to_tp, enter_tp, expert_comm, leave_tp
from ..distributed.sharding import current_mesh
from ..kernels.moe_dispatch.ops import dispatch_combine
from ..sched import ExpertCapacityProvider
from .layers import _norm_init


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
    ``base``: (E,) pre-occupied slots per expert (round 2)."""
    T, K = expert_ids.shape
    flat = expert_ids.t().reshape(-1)                  # choice-major (K*T,)
    # (E, K*T) one-hot, counted along its contiguous last dim: the scan
    # over the first dim of a (K*T, E) int64 one-hot is a slow CUDA kernel
    onehot = flat[None, :] == torch.arange(E, device=flat.device)[:, None]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 0, flat[None, :])[0].long()
    if base is not None:
        pos = pos + base[flat]
    return pos.reshape(K, T).t()                       # (T, K)


def _expert_load(expert_ids: torch.Tensor, mask: torch.Tensor, E: int):
    flat = expert_ids.reshape(-1)
    return torch.sum(F.one_hot(flat, E) * mask.reshape(-1)[:, None], dim=0)


def dlbc_reroute(ids, gates, probs, pos1, keep1, load, provider,
                 n_groups: int, expert_open, group_of=None):
    """The DLBC round-2 re-route (a "group" is an expert here).

    Overflow (token, choice) pairs re-route once to the token's best
    expert among ``expert_open`` (the (E,) availability mask from the
    provider's residual), take positions after the ``load`` already
    admitted per group, and are re-admitted against the same provider.
    Returns ``(ids_f, group_f, pos_f, keep, gates_f, overflow)`` —
    rerouted pairs weighted by the probability of the expert that serves
    them."""
    group_of = group_of or (lambda i: i)
    overflow = ~keep1                                  # (T, K)
    avail = probs * expert_open[None, :].to(probs.dtype)
    alt_ids = torch.argmax(avail, dim=-1)              # first maximum
    ids2 = torch.where(overflow, alt_ids[:, None], ids)
    group2 = group_of(ids2)
    pos2 = _positions_in_expert(
        torch.where(overflow, group2, n_groups),       # only overflow counts
        n_groups + 1,
        base=torch.cat([load, torch.zeros((1,), dtype=load.dtype,
                                          device=load.device)]))
    ids_f = torch.where(overflow, ids2, ids)
    group_f = torch.where(overflow, group2, group_of(ids))
    pos_f = torch.where(overflow, pos2, pos1)
    keep = provider.admit_mask(pos_f)
    alt_gate = torch.gather(probs, -1, ids_f).to(gates.dtype)
    gates_f = torch.where(overflow, alt_gate, gates)
    return ids_f, group_f, pos_f, keep, gates_f, overflow


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
              ep=None, sp: bool = False):
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
    reduce-scattered, the round's whole result sliced."""
    orig_shape = x.shape
    # routing and the EP round compute alike on every model rank
    xr = enter_tp(x, tp, split=False, gathered=sp).reshape(-1, x.shape[-1])
    x = x.reshape(-1, x.shape[-1])
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if ep is None:
        ep = expert_comm(current_mesh(), cfg)
    if ep is not None:
        # Expert-parallel all-to-all dispatch (repro_torch.ep).  A token
        # count not divisible by S is zero-padded up to the next multiple
        # and sliced back.
        from ..ep.dispatch import ep_dispatch_combine
        pad = (-T) % ep.size
        xp = F.pad(xr, (0, 0, 0, pad)) if pad else xr
        out = ep_dispatch_combine(p, cfg, xp, comm=ep, tp=tp,
                                  use_kernel=use_kernel,
                                  return_stats=return_stats)
        y, ep_stats = out if return_stats else (out, None)
        y = leave_tp((y[:T] if pad else y).reshape(orig_shape), tp,
                     split=False, sp=sp)
        if return_stats:
            ep_stats["padded_tokens"] = pad
            return y, ep_stats
        return y
    C = capacity(T, E, K, cfg.moe_capacity_factor)
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

    if cfg.moe_dispatch == "lc":
        pos = _positions_in_expert(ids, E)
        keep = cap.admit_mask(pos)
        y = run(gates, ids, pos, keep)
    else:
        pos1 = _positions_in_expert(ids, E)
        keep1 = cap.admit_mask(pos1)
        rounds = 2
        load = _expert_load(ids, keep1, E)          # (E,) used slots
        resid = cap.residual(load)                  # idle capacity
        ids_final, _, pos_final, keep, gates_final, _ = dlbc_reroute(
            ids, gates, probs, pos1, keep1, load, cap, E,
            expert_open=resid > 0)
        y = run(gates_final, ids_final, pos_final, keep)
    y = leave_tp(y.reshape(orig_shape), tp, sp=sp)
    if return_stats:
        return y, {"dropped_frac": torch.sum(~keep) / (T * K),
                   "spawns": torch.sum(keep),
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
