"""Train-step builder: microbatch accumulation × AFE sync policies.

Port of ``repro/train/train_step.py``.  The reference's four policies
differ in where gradient synchronisation happens in the compiled step:

* ``unopt``      — every microbatch's gradients all-reduced inside the
                   accumulation loop (the join inside the recursion);
* ``lc``         — one all-reduce per tensor at step end;
* ``afe``        — FSDP: reduce-scatters to the param sharding;
* ``afe_bucket`` — the step-end gradients concatenated into a few
                   size-balanced flat buckets (finish fusion), optionally
                   compressed to bf16.

The port has no mesh until ROADMAP Queue 1 item 11 (distribution), so
the sharding constraints are the identity and the policies differ only in
``afe_bucket``'s flatten/unflatten and its bf16 rounding; the places where
item 11 puts each policy's collectives are marked ``[item 11]`` below.
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

from ..configs.base import ModelConfig, ShapeConfig
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
    remat: bool = True            # accepted; no effect (models.model.forward)


def _bucketize(grads, n_buckets: int, policy=None, capacity=None):
    """Concatenate raveled grads into fp32 reduction buckets.

    The bucket count comes from the scheduling policy's plan over the leaf
    list (the Fig. 6 arithmetic over ``capacity``, default ``n_buckets``
    reduction streams, all but the caller's idle); payload is spread over
    that many buckets by greedy LPT on element counts, the caller keeping
    the lightest bucket, ordered last.  Without a policy, or when it
    declines the parallel arm, LPT into ``n_buckets`` bins.  Leaves are
    taken in the reference's order (dict keys sorted), so the bins are the
    reference's.

    Returns ``(flatten, unflatten)``.
    """
    leaves = tree_leaves(grads)
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


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     scfg: StepConfig, ocfg: AdamWConfig):
    """Returns ``(step, dp_shard)``: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, params and state updated in place;
    ``metrics`` holds the reference's keys and ``loss``.

    ``dp_shard`` (FSDP) is on for the afe policies, off for unopt/lc; it
    takes effect once the port has a mesh (item 11).
    """
    dp_shard = scfg.policy in ("afe", "afe_bucket")
    M = max(1, shape.microbatches)
    fwd_kw = dict(schedule=scfg.schedule, q_chunk=scfg.q_chunk,
                  k_chunk=scfg.k_chunk, ssm_chunk=scfg.ssm_chunk,
                  remat=scfg.remat)

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
        # leaves that share the params' storage and require grad; the
        # caller's tensors are left as they are until the in-place update
        views = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        vparams = tree_unflatten(params, views)
        acc, loss_sum = None, 0.0
        for i in range(M):
            mb = {k: v[i * (B // M):(i + 1) * (B // M)]
                  for k, v in batch.items()}
            loss = MDL.loss_fn(vparams, cfg, mb, **fwd_kw)
            g = torch.autograd.grad(loss, views)
            loss_sum = loss_sum + loss.detach()
            del loss
            # [item 11] unopt: all-reduce g here (every microbatch);
            # afe / afe_bucket: reduce-scatter g to the param sharding
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float())
            del g
        for a in acc:
            a.div_(M)
        grads = tree_unflatten(params, acc)

        # --- step-end synchronisation per policy ------------------------
        # [item 11] lc: all-reduce each gradient; afe: reduce-scatter to
        # the param sharding
        if scfg.policy == "afe_bucket":
            flatten, unflatten = _bucketize(grads, scfg.n_buckets,
                                            policy=sched_pol,
                                            capacity=sched_cap)
            buckets = flatten(acc)
            del acc
            if scfg.grad_compress == "bf16":
                buckets = [b.to(torch.bfloat16) for b in buckets]
            # [item 11] the flat buckets are reduce-scattered here, sharded
            # over every mesh axis
            buckets = [b.float() for b in buckets]
            grads = unflatten(buckets)

        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  ocfg)
        # beside the reference's metrics: the mean microbatch loss at the
        # params the step started from (free: the gradients needed it)
        metrics["loss"] = loss_sum / M
        return params, opt_state, metrics

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
