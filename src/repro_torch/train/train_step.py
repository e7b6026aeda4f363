"""Train-step builder: microbatch accumulation × AFE sync policies.

Port of ``repro/train/train_step.py``.  The reference's four policies
differ in where gradient synchronisation happens in the step; under a
mesh (:func:`repro_torch.distributed.sharding.mesh_context`, a
``DeviceMesh`` whose ``"model"`` axis is 1) the port issues them as
``torch.distributed`` collectives over the mesh's data ranks, each rank
taking its rows of every microbatch (the reference's ``P("data", None)``
batch sharding):

* ``unopt``      — every microbatch's gradients all-reduced inside the
                   accumulation loop (the join inside the recursion);
* ``lc``         — one all-reduce per tensor at step end;
* ``afe``        — FSDP/ZeRO: the optimizer state (fp32 master, m, v)
                   lives sharded along the dim that ``param_specs_tree(...,
                   dp_shard=True)`` gives the fsdp axes (:class:`FsdpLayout`),
                   the gradients are reduce-scattered once per step onto
                   that sharding (a replicated leaf's all-reduced), AdamW
                   updates each shard, and the working params are
                   all-gathered once after the update;
* ``afe_bucket`` — as ``afe``, with the step-end gradients packed into a
                   few size-balanced flat buckets (finish fusion), each
                   reduce-scattered in one call (its rows laid out rank by
                   rank, so that every rank receives its FSDP pieces), the
                   replicated leaves all-reduced as one flat bucket, and
                   the params all-gathered by bucket; optionally
                   compressed to bf16.

Every reduction is a mean over the data ranks (a sum, then a division).
The ``afe`` policies all-reduce the gradient norm's per-leaf sums before
clipping, so the non-finite guard agrees on every rank.  Each call counts
its collectives by kind (:class:`~repro_torch.distributed.comm.Collectives`,
the counterpart of the reference's ``collective_stats`` over HLO) in
``metrics["collectives"]``.  Without a mesh no collective runs and the
policies differ only in ``afe_bucket``'s flatten/unflatten and its bf16
rounding.  A mesh with an expert axis larger than 1 (EP under autograd)
or a model axis larger than 1 raises ``NotImplementedError``.

The math is the reference's: per-microbatch gradients of ``loss_fn``
(autograd; on the card through the kernels' backward kernels), summed in
fp32, divided by the microbatch count, then AdamW
(:func:`~.optimizer.adamw_update`, in place).

Scheduling is the reference's too: one ``repro_torch.sched`` policy plans
the microbatch chunks (the reference's scan unroll, kept here as the
schedule record: eager PyTorch runs the microbatches one after another)
and the gradient buckets, and ``step.sched_counts`` records the static
spawn/join counts per executed step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.comm import Collectives, mesh_group
from ..distributed.sharding import (
    current_mesh, expert_axis_size, fsdp_layout, require_executable,
)
from ..models import model as MDL
from ..sched import FixedCapacity, get_policy
from ..tree import tree_leaves, tree_unflatten
from .optimizer import AdamWConfig, adamw_update

POLICIES = ("unopt", "lc", "afe", "afe_bucket")


@dataclass(frozen=True)
class StepConfig:
    policy: str = "afe"
    grad_compress: str = "none"   # none | bf16
    n_buckets: int = 4            # reduction streams (afe_bucket width)
    sched_policy: str = "dlbc"    # repro_torch.sched policy scheduling the
                                  # step: microbatch chunks + gradient buckets
    schedule: str = "masked"      # attention chunk schedule (masked | tri)
    q_chunk: int = 1024
    k_chunk: int = 1024
    ssm_chunk: int = 256
    remat: bool = True            # checkpoint each layer (models.model.forward)


def _bucket_bins(leaves, n_buckets: int, policy=None, capacity=None):
    """The reference's bucket plan over ``leaves``: lists of leaf indices.

    The bucket count comes from the scheduling policy's plan over the leaf
    list (the Fig. 6 arithmetic over ``capacity``, default ``n_buckets``
    reduction streams, all but the caller's idle); payload is spread over
    that many buckets by greedy LPT on element counts, the caller keeping
    the lightest bucket, ordered last.  Without a policy, or when it
    declines the parallel arm, LPT into ``n_buckets`` bins.  Leaves are
    taken in the reference's order (dict keys sorted), so the bins are the
    reference's."""
    sizes = [int(l.numel()) for l in leaves]
    order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
    nb = n_buckets
    caller_last = False
    if policy is not None:
        policy = get_policy(policy)
        if capacity is None:
            capacity = FixedCapacity(idle_n=n_buckets - 1, total_n=n_buckets)
        plan = policy.decide(0, len(leaves), capacity).plan
        if plan is not None:
            nb = len([c for c in plan.chunks if c[1] > c[0]])
            caller_last = plan.caller[1] > plan.caller[0]
    nb = max(1, min(nb, len(sizes) or 1))
    bins = [[] for _ in range(nb)]
    bin_sz = [0] * nb
    for i in order:
        j = min(range(nb), key=lambda b: bin_sz[b])
        bins[j].append(i)
        bin_sz[j] += sizes[i]
    bins = [b for b in bins if b]
    if caller_last:
        # the caller keeps the smallest chunk: lightest payload last
        bins.sort(key=lambda b: -sum(sizes[i] for i in b))
    return bins


def _bucketize(grads, n_buckets: int, policy=None, capacity=None):
    """Concatenate raveled grads into fp32 reduction buckets, binned by
    :func:`_bucket_bins`.  Returns ``(flatten, unflatten)``."""
    leaves = tree_leaves(grads)
    sizes = [int(l.numel()) for l in leaves]
    bins = _bucket_bins(leaves, n_buckets, policy, capacity)

    def flatten(grads_leaves):
        return [torch.cat([grads_leaves[i].reshape(-1).float() for i in b])
                for b in bins]

    def unflatten(buckets):
        new = [None] * len(leaves)
        for bk, b in zip(buckets, bins):
            off = 0
            for i in b:
                n = sizes[i]
                new[i] = bk[off:off + n].reshape(leaves[i].shape)
                off += n
        return tree_unflatten(grads, new)

    return flatten, unflatten


# --- collectives of the policies (``comm``: the step's Collectives) --------


def _mean(comm, t):
    """All-reduce ``t`` in place to its mean over the group."""
    return comm.all_reduce(t).div_(comm.size)


def _rows(t, dim: int, size: int):
    """``t`` with ``dim`` moved first, zero-padded to a multiple of
    ``size`` rows and split rank by rank: ``(size, rows · rest)``."""
    t = t.movedim(dim, 0)
    c = -(-t.shape[0] // size)
    if c * size != t.shape[0]:
        t = torch.cat([t, t.new_zeros((c * size - t.shape[0],
                                       *t.shape[1:]))])
    return t.reshape(size, -1)


def _piece_shape(shape, dim: int, size: int):
    """The shape of one rank's FSDP piece of a ``shape`` tensor."""
    out = list(shape)
    out[dim] = -(-shape[dim] // size)
    return tuple(out)


def _unpack(flat, shapes, dims):
    """Split a flat tensor into pieces of ``shapes`` whose ``dims`` were
    moved first when packed (:func:`_rows`)."""
    out, off = [], 0
    for shp, d in zip(shapes, dims):
        moved = (shp[d], *shp[:d], *shp[d + 1:])
        n = 1
        for x in shp:
            n *= x
        out.append(flat[off:off + n].reshape(moved).movedim(0, d)
                   .contiguous())
        off += n
    return out


def _reduce_scatter(comm, grads, dims, compress: bool = False):
    """One reduce-scatter of ``grads`` (packed rank by rank): this rank's
    FSDP pieces of their mean over the group."""
    packed = torch.cat([_rows(g, d, comm.size) for g, d in zip(grads, dims)],
                       dim=1)
    if compress:
        packed = packed.to(torch.bfloat16)
    flat = comm.reduce_scatter(packed.reshape(-1)).float().div_(comm.size)
    return _unpack(flat, [_piece_shape(g.shape, d, comm.size)
                          for g, d in zip(grads, dims)], dims)


def _all_gather(comm, pieces, dims, shapes):
    """One all-gather of every rank's FSDP ``pieces`` (one dtype): the
    whole tensors of ``shapes``."""
    flat = torch.cat([x.movedim(d, 0).reshape(-1)
                      for x, d in zip(pieces, dims)])
    got = comm.all_gather(flat).reshape(comm.size, -1)
    out, off = [], 0
    for x, d, shp in zip(pieces, dims, shapes):
        n = x.numel()
        rows = got[:, off:off + n].reshape(comm.size * x.shape[d], -1)
        out.append(rows[:shp[d]].reshape(
            (shp[d], *shp[:d], *shp[d + 1:])).movedim(0, d))
        off += n
    return out


def _dtype_groups(idx, leaves):
    """``idx`` split by the dtype of ``leaves[i]`` (first-seen order)."""
    groups: dict = {}
    for i in idx:
        groups.setdefault(leaves[i].dtype, []).append(i)
    return list(groups.values())


def _sync_buckets(comm, acc, dims, bins, compress: bool):
    """``afe_bucket``'s step-end sync: the FSDP-sharded leaves of each of
    the reference's buckets in one reduce-scatter; the replicated leaves
    in one flat all-reduce.  Returns per leaf this rank's piece (sharded)
    or the whole mean gradient (replicated)."""
    out = list(acc)
    for bin_ in bins:
        idx = [i for i in bin_ if dims[i] is not None]
        if idx:
            got = _reduce_scatter(comm, [acc[i] for i in idx],
                                  [dims[i] for i in idx], compress)
            for i, g in zip(idx, got):
                out[i] = g
    rep = [i for i, d in enumerate(dims) if d is None]
    if rep:
        flat = torch.cat([acc[i].reshape(-1) for i in rep])
        if compress:
            flat = flat.to(torch.bfloat16)
        flat = _mean(comm, flat).float()
        off = 0
        for i in rep:
            n = acc[i].numel()
            out[i] = flat[off:off + n].reshape(acc[i].shape)
            off += n
    return out


def _check_sharded(opt_state, leaves, dims, size: int) -> None:
    """Refuse a whole optimizer state where the layout shards it."""
    for m, p, d in zip(tree_leaves(opt_state["m"]), leaves, dims):
        want = p.shape if d is None else _piece_shape(p.shape, d, size)
        if tuple(m.shape) != tuple(want):
            raise ValueError(
                f"optimizer state leaf of shape {tuple(m.shape)} where this "
                f"rank's FSDP piece is {tuple(want)}: build the state with "
                "init_opt_state(params, ocfg, layout=step.layout)")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     scfg: StepConfig, ocfg: AdamWConfig):
    """Returns ``(step, dp_shard)``: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, params and state updated in place;
    ``metrics`` holds the reference's keys, ``loss`` (this rank's mean
    microbatch loss) and ``collectives`` (the call's counts by kind).

    ``dp_shard`` (FSDP) is on for the afe policies, off for unopt/lc.
    Under a mesh ``step.layout`` is the :class:`FsdpLayout` of the afe
    policies' optimizer state (``None`` otherwise): build the state with
    ``init_opt_state(params, ocfg, layout=step.layout)``.
    """
    dp_shard = scfg.policy in ("afe", "afe_bucket")
    M = max(1, shape.microbatches)
    fwd_kw = dict(schedule=scfg.schedule, q_chunk=scfg.q_chunk,
                  k_chunk=scfg.k_chunk, ssm_chunk=scfg.ssm_chunk,
                  remat=scfg.remat)
    mesh = current_mesh()
    group = layout = None
    if mesh is not None:
        require_executable(mesh)
        if expert_axis_size(mesh) > 1:
            raise NotImplementedError(
                "a train step on a mesh with an expert axis (EP under "
                "autograd) is not ported yet (ROADMAP Queue 1: EP under "
                "autograd)")
        group = mesh_group(mesh)
        if dp_shard:
            layout = fsdp_layout(MDL.param_shapes(cfg), cfg,
                                 dist.get_rank(group),
                                 dist.get_world_size(group))
    dims = tree_leaves(layout.dims) if layout is not None else None

    # --- scheduling (repro_torch.sched), as in the reference: capacity =
    # the step's reduction streams; the microbatch plan's largest chunk is
    # the reference's scan unroll; the bucket plan partitions the leaves.
    sched_pol = get_policy(scfg.sched_policy)
    sched_cap = FixedCapacity(idle_n=scfg.n_buckets - 1,
                              total_n=scfg.n_buckets)
    mb_plan = sched_pol.decide(0, M, sched_cap).plan if M > 1 else None
    mb_unroll = max([1] + [b - a for a, b in mb_plan.chunks]) \
        if mb_plan is not None else 1
    spawns_per_step = len(mb_plan.spawned) if mb_plan is not None else 0
    if scfg.policy == "afe_bucket":
        n_leaves = len(tree_leaves(MDL.param_shapes(cfg)))
        bplan = sched_pol.decide(0, n_leaves, sched_cap).plan
        # serial arm (plan None) builds its buckets on the caller: 0 spawns
        spawns_per_step += len(bplan.spawned) if bplan is not None else 0
    sched_counts = {
        "policy": sched_pol.name,
        "spawns": spawns_per_step,
        # nothing spawned (serial arm) → nothing to join; DCAFE escapes
        # its join to the trainer's outer finish
        "joins": 0 if (sched_pol.escape_join or spawns_per_step == 0)
        else 1,
        "mb_unroll": mb_unroll,
        "escape_join": sched_pol.escape_join,
    }

    def step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"global batch {B} does not split into {M} "
                             f"microbatches")
        b = B // M
        comm = Collectives(group) if mesh is not None else None
        lo, hi = 0, b
        if comm is not None:
            if b % comm.size:
                raise ValueError(f"a microbatch of {b} rows does not split "
                                 f"over {comm.size} data ranks")
            lo, hi = comm.rank * b // comm.size, \
                (comm.rank + 1) * b // comm.size
        leaves = tree_leaves(params)
        bins = _bucket_bins(leaves, scfg.n_buckets, sched_pol, sched_cap) \
            if scfg.policy == "afe_bucket" else None
        if layout is not None:
            _check_sharded(opt_state, leaves, dims, layout.size)
        # leaves that share the params' storage and require grad; the
        # caller's tensors are left as they are until the in-place update
        views = [p.detach().requires_grad_(True) for p in leaves]
        vparams = tree_unflatten(params, views)
        acc, loss_sum = None, 0.0
        for i in range(M):
            mb = {k: v[i * b + lo:i * b + hi] for k, v in batch.items()}
            loss = MDL.loss_fn(vparams, cfg, mb, **fwd_kw)
            g = torch.autograd.grad(loss, views)
            loss_sum = loss_sum + loss.detach()
            del loss
            if comm is not None and scfg.policy == "unopt":
                # the join inside the loop: every microbatch all-reduced
                g = [_mean(comm, x.float()) for x in g]
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float())
            del g
        for a in acc:
            a.div_(M)

        # --- step-end synchronisation per policy ------------------------
        compress = scfg.grad_compress == "bf16"
        if comm is None:
            if scfg.policy == "afe_bucket":
                flatten, unflatten = _bucketize(
                    tree_unflatten(params, acc), scfg.n_buckets,
                    policy=sched_pol, capacity=sched_cap)
                buckets = flatten(acc)
                del acc
                if compress:
                    buckets = [b.to(torch.bfloat16) for b in buckets]
                acc = tree_leaves(unflatten([b.float() for b in buckets]))
        elif scfg.policy == "lc":
            acc = [_mean(comm, a) for a in acc]
        elif scfg.policy == "afe":
            acc = [_mean(comm, a) if d is None else
                   _reduce_scatter(comm, [a], [d])[0]
                   for a, d in zip(acc, dims)]
        elif scfg.policy == "afe_bucket":
            acc = _sync_buckets(comm, acc, dims, bins, compress)
        grads = tree_unflatten(params, acc)
        del acc

        if layout is None:
            params, opt_state, metrics = adamw_update(params, grads,
                                                      opt_state, ocfg)
        else:
            # each rank updates its FSDP pieces, then the whole params are
            # all-gathered: per leaf (afe) or per bucket and dtype
            # (afe_bucket)
            pieces = [p if d is None else layout.local(p.detach(), d)
                      for p, d in zip(leaves, dims)]
            _, opt_state, metrics = adamw_update(
                tree_unflatten(params, pieces), grads, opt_state, ocfg,
                comm=comm, sharded=[d is not None for d in dims])
            sharded = [i for i, d in enumerate(dims) if d is not None]
            groups = [[i] for i in sharded] if scfg.policy == "afe" else \
                [g for bin_ in bins
                 for g in _dtype_groups([i for i in bin_ if dims[i]
                                         is not None], leaves)]
            with torch.no_grad():
                for idx in groups:
                    whole = _all_gather(comm, [pieces[i] for i in idx],
                                        [dims[i] for i in idx],
                                        [leaves[i].shape for i in idx])
                    for i, w in zip(idx, whole):
                        leaves[i].copy_(w)
        # beside the reference's metrics: the mean microbatch loss at the
        # params the step started from (free: the gradients needed it)
        metrics["loss"] = loss_sum / M
        metrics["collectives"] = dict(comm.counts) if comm is not None \
            else {}
        return params, opt_state, metrics

    step.layout = layout
    # Static per-step schedule record: the trainer multiplies these by
    # executed steps into its SchedTelemetry (Fig. 10 spawn/join JSON).
    step.sched_counts = sched_counts
    return step, dp_shard


def build_eval_loss(cfg: ModelConfig, scfg: StepConfig):
    fwd_kw = dict(schedule=scfg.schedule, q_chunk=scfg.q_chunk,
                  k_chunk=scfg.k_chunk, ssm_chunk=scfg.ssm_chunk,
                  remat=scfg.remat)

    @torch.no_grad()
    def eval_loss(params, batch):
        return MDL.loss_fn(params, cfg, batch, **fwd_kw)

    return eval_loss


def build_prefill_step(cfg: ModelConfig, scfg: StepConfig):
    fwd_kw = dict(schedule=scfg.schedule, q_chunk=scfg.q_chunk,
                  k_chunk=scfg.k_chunk, ssm_chunk=scfg.ssm_chunk,
                  remat=scfg.remat)

    @torch.no_grad()
    def prefill(params, batch):
        logits = MDL.forward(params, cfg, batch, last_only=True, **fwd_kw)
        return logits[:, -1]  # next-token logits

    return prefill


def build_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return MDL.decode_step(params, cfg, cache, batch)

    return serve_step
