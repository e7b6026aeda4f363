"""Counted collectives over one process group, and the tensor-parallel
region's two autograd functions.

The reference counts its collectives in the compiled HLO
(``roofline.analysis.collective_stats``); the port issues them eagerly, so
it counts them where it issues them: every method of :class:`Collectives`
makes one ``torch.distributed`` call and adds one to its kind's count.
A train step makes one :class:`Collectives` per call over the data ranks
and returns its ``counts`` in the step's metrics, one over the model
ranks (:func:`model_comm`) whose counts it returns apart, as
``metrics["tp_collectives"]``, and one over the expert ranks
(:func:`expert_comm`), as ``metrics["ep_collectives"]``; the EP round
makes one per round when it is not given one.

Tensor parallelism (the ``"model"`` mesh axis) is Megatron's with
sequence parallelism, as the reference's ``shard_act`` lays it out:
between layers a model rank holds rows ``[j·S/m, (j+1)·S/m)`` of the
``(B, S, d)`` residual stream whenever ``m`` divides S
(:func:`~repro_torch.distributed.sharding.seq_sharded`).  A layer's
normed input is all-gathered over the sequence before its column-parallel
matmuls (:func:`gather_from_sp`: the gradient's partial sums
reduce-scattered back) and its row-parallel partial sums leave by a
reduce-scatter over the sequence (:func:`reduce_scatter_to_sp`: the
gradient all-gathered).  A consumer of the gathered rows that computes
alike on every model rank (attention whose heads do not split, MoE
routing) reads them through :func:`keep_block_grad`, so that its whole
gradient counts once in that reduce-scatter; attention that runs whole
leaves by taking this rank's block (:func:`slice_to_sp`).  Where ``m``
does not divide S (ragged lengths, decode at S = 1) the activations are
whole on every model rank: a column-parallel matmul takes them through
:func:`copy_to_tp` (identity forward, all-reduce of the input's gradient
backward) and a row-parallel matmul's partial sums leave through
:func:`reduce_from_tp` (all-reduce forward, identity backward);
:func:`enter_tp` / :func:`leave_tp` pick the pair.  Each function keeps
its :class:`Collectives` in the autograd context, so a backward (on the
autograd engine's thread) and a rematerialised forward issue and count
through the same object as the forward did.

Expert parallelism (the ``"expert"`` axis) under autograd is the
counterpart of what ``jax.grad`` does to the reference's ``shard_map``:
the expert ranks hold the same token matrix, each takes its block of
rows into the round (:func:`slice_to_ep`: the block's gradient is
all-gathered backward, since the upstream layers run alike on every
rank and need the whole of it), the lane exchange is an all-to-all whose
backward is the same exchange of the gradient (:func:`exchange_ep`; the
permutation is its own inverse), and the shards' outputs leave through
an all-gather whose backward keeps this rank's block of the gradient and
issues nothing (:func:`gather_from_ep`: the loss downstream is the same
on every rank).  The router enters the round replicated, so its gradient
is partial on each expert rank; the train step sums it over the expert
ranks once per step, with the step-end sync (one all-reduce per step in
place of one per layer and microbatch).

All reductions are sums unless ``op="max"`` (gloo has no average);
callers divide.

The dry run (:mod:`repro_torch.launch.dryrun`) traces one rank's step on
the meta device over a mesh that exists only as a
:class:`~.sharding.MeshShape`: there :func:`mesh_group`,
:func:`model_comm` and :func:`expert_comm` give :class:`MeshGroup` groups,
and a :class:`Collectives` over one takes its size from the axes and its
rank as mesh rank 0's, makes no ``torch.distributed`` call and returns
outputs of the right shapes (on meta tensors, empty ones).  Every
collective, traced or issued, reports its kind and result bytes to the
active op counter (:mod:`repro_torch.roofline.sink`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..roofline import sink
from .sharding import (
    EXPERT_AXIS, axis_sizes, expert_axis_size, ep_takes_experts,
)

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
         "send_recv")


def axis_groups(mesh, axes) -> list:
    """The rank lists of the groups over the mesh axes ``axes``: one per
    coordinate of the other axes (row-major), each the ranks that share
    that coordinate, row-major over ``axes`` (so ascending, and a rank's
    place in its list is its index over ``axes``).  Reads only the mesh's
    names, sizes and (for a ``DeviceMesh``) its rank layout: pure
    arithmetic, no process group."""
    axes = [a for a in mesh.mesh_dim_names if a in axes]
    ranks = getattr(mesh, "mesh", None)
    if ranks is None:
        ranks = torch.arange(math.prod(mesh.shape)).reshape(
            tuple(mesh.shape))
    names = list(mesh.mesh_dim_names)
    others = [names.index(a) for a in names if a not in axes]
    inner = [names.index(a) for a in axes]
    n = math.prod(ranks.shape[d] for d in inner)
    return ranks.permute(others + inner).reshape(-1, n).tolist()


@dataclass(frozen=True)
class MeshGroup:
    """The group over ``axes`` of a mesh with no process groups (a
    :class:`~.sharding.MeshShape`): mesh rank 0's, the rank the dry run
    traces.  A :class:`Collectives` over one makes no call."""

    mesh: object
    axes: tuple

    @property
    def size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.axes)


def _traced(mesh) -> bool:
    """A mesh without process groups (a ``MeshShape``): the dry run's."""
    return not hasattr(mesh, "get_group")


def mesh_group(mesh, axes):
    """The process group over the mesh axes ``axes`` (one name or a tuple,
    e.g. the data-parallel ``("pod", "data")``): the group of the one such
    axis larger than 1 (the first present one when none is), the default
    group when several are wide and together span the world, else the
    group of the ranks that share this rank's coordinates on every other
    axis (:func:`axis_groups`).  Every rank creates every such group, in
    the same order, as ``torch.distributed`` requires; they are made once
    per mesh and kept on it."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    present = [a for a in axes if a in sizes]
    wide = tuple(a for a in present if sizes[a] > 1)
    if _traced(mesh):
        return MeshGroup(mesh, wide or tuple(present[:1]))
    if len(wide) <= 1:
        return mesh.get_group(wide[0] if wide else present[0])
    if math.prod(sizes[a] for a in wide) == dist.get_world_size():
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if wide not in cache:
        me = dist.get_rank()
        for ranks in axis_groups(mesh, wide):
            group = dist.new_group(ranks)
            if me in ranks:
                cache[wide] = group
    return cache[wide]


class Collectives:
    """One group's collectives, counted by kind in :attr:`counts`.  Over a
    :class:`MeshGroup` (the dry run) nothing is issued: the results have
    the right shapes and ``t``'s values are left as they are.  ``axes``:
    the mesh axes the group spans, where a caller reads them (a
    context-parallel group, :func:`context_comm`)."""

    def __init__(self, group=None, axes: tuple = ()):
        self.group = group if group is not None else dist.group.WORLD
        self.axes = tuple(axes)
        self.traced = isinstance(self.group, MeshGroup)
        if self.traced:
            self.size, self.rank = self.group.size, 0
        else:
            self.size = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
        self.counts = dict.fromkeys(KINDS, 0)

    def _count(self, kind: str, out: torch.Tensor) -> None:
        self.counts[kind] += 1
        sink.collective(kind, out.numel() * out.element_size())

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or with ``op="max"`` take the maximum of) ``t`` over the
        group, in place; returns ``t``."""
        if not self.traced:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=self.group)
        self._count("all_reduce", t)
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group and return this rank's block of its
        leading dim (a multiple of the group size)."""
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        if not self.traced:
            dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        self._count("reduce_scatter", out)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along the leading dim, rank-major."""
        out = t.new_empty((t.shape[0] * self.size, *t.shape[1:]))
        if not self.traced:
            dist.all_gather_into_tensor(out, t.contiguous(),
                                        group=self.group)
        self._count("all_gather", out)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of ``t``'s leading dim goes to rank ``j``; block
        ``i`` of the result came from rank ``i``."""
        out = torch.empty_like(t)
        if not self.traced:
            dist.all_to_all_single(out, t.contiguous(), group=self.group)
        self._count("all_to_all", out)
        return out

    def send_recv(self, send: torch.Tensor, dst: int, recv: torch.Tensor,
                  src: int) -> None:
        """One ring hop: ``send`` to group rank ``dst`` while ``recv``
        (contiguous, written in place) arrives from group rank ``src``."""
        if not self.traced:
            ranks = dist.get_process_group_ranks(self.group)
            ops = [dist.P2POp(dist.isend, send.contiguous(), ranks[dst],
                              self.group),
                   dist.P2POp(dist.irecv, recv, ranks[src], self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self._count("send_recv", recv)


def expert_comm(mesh, cfg) -> Optional[Collectives]:
    """A :class:`Collectives` over ``mesh``'s ``"expert"`` axis when
    ``cfg``'s MoE layers take the EP round on it (the config opts into
    ``expert_parallel`` and the axis, larger than 1, divides E), else
    None.  A ``"model"`` axis beside it runs the round inside the
    tensor-parallel region (:func:`model_comm`); the ``DeviceMesh`` built
    every axis's group when it was made, so this and :func:`model_comm`
    create no group and may be called in any order."""
    if mesh is None or not ep_takes_experts(cfg, expert_axis_size(mesh)):
        return None
    return Collectives(mesh_group(mesh, EXPERT_AXIS))


def context_comm(mesh, axes) -> Optional[Collectives]:
    """A :class:`Collectives` over the mesh axes ``axes`` that carry a
    decode cache's time axis (``sharding.cache_layout(...).time``), which
    it keeps as its ``axes``; None when they span one rank (``T`` whole).
    A rank's place in the group is its index over ``axes``, row-major: the
    block of ``T`` it holds."""
    sizes = axis_sizes(mesh)
    if math.prod(sizes[a] for a in axes) <= 1:
        return None
    return Collectives(mesh_group(mesh, axes), axes=axes)


def model_comm(mesh) -> Optional[Collectives]:
    """A :class:`Collectives` over ``mesh``'s ``"model"`` axis, or None
    when there is no mesh or its model axis is 1 (no tensor parallelism)."""
    if mesh is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if sizes.get("model", 1) <= 1:
        return None
    return Collectives(mesh_group(mesh, "model"))


# ---------------------------------------------------------------------------
# The tensor-parallel region (Megatron's f and g)
# ---------------------------------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromTP(torch.autograd.Function):
    """Partial sums summed over the model ranks; identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ShareKV(torch.autograd.Function):
    """A weight that several model ranks hold alike (one KV head, read by
    the query heads of ``m / KV`` ranks): identity forward; backward, each
    rank's partial gradient summed over the ranks that hold the same head,
    through one all-reduce of a ``(KV, ...)`` buffer in which every rank
    fills its head's slot."""

    @staticmethod
    def forward(ctx, w, tp, head, n_heads):
        ctx.tp, ctx.head, ctx.n_heads = tp, head, n_heads
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        buf = g.new_zeros((ctx.n_heads, *g.shape))
        buf[ctx.head] = g
        return ctx.tp.all_reduce(buf)[ctx.head], None, None, None


def copy_to_tp(x: torch.Tensor, tp: Optional[Collectives]) -> torch.Tensor:
    """Enter the tensor-parallel region (before a column-parallel matmul):
    ``x`` as it is, its gradient all-reduced over ``tp``'s ranks.  The
    identity without ``tp``."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[Collectives]
                   ) -> torch.Tensor:
    """Leave the tensor-parallel region (after a row-parallel matmul):
    ``x``'s partial sums all-reduced over ``tp``'s ranks, its gradient
    passed through.  The identity without ``tp``."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def share_kv(w: torch.Tensor, tp: Optional[Collectives], head: int,
             n_heads: int) -> torch.Tensor:
    """``w``, one KV head's weight that the ranks reading head ``head`` of
    ``n_heads`` hold alike; its gradient summed over those ranks."""
    return w if tp is None else _ShareKV.apply(w, tp, head, n_heads)


# ---------------------------------------------------------------------------
# Sequence parallelism on the model axis (the reference's shard_act)
# ---------------------------------------------------------------------------
#
# Collectives.all_gather / reduce_scatter work on the leading dim; the
# sequence is dim 1 of (B, S, ...), so each function moves it first and
# back (the ranks' blocks stay in rank order).


def _seq(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(0, 1)


class _GatherFromSP(torch.autograd.Function):
    """The ranks' sequence blocks all-gathered; backward, the gradient's
    partial sums reduce-scattered to this rank's block."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq(tp.all_gather(_seq(x))).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _seq(ctx.tp.reduce_scatter(_seq(g))), None


class _ReduceScatterToSP(torch.autograd.Function):
    """Partial sums summed over the model ranks, this rank's sequence
    block kept; backward, the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq(tp.reduce_scatter(_seq(x))).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _seq(ctx.tp.all_gather(_seq(g))), None


class _KeepBlockGrad(torch.autograd.Function):
    """Identity forward; backward, the gradient with every row outside
    this rank's sequence block zeroed, no collective."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // ctx.tp.size
        lo = ctx.tp.rank * n
        out = torch.zeros_like(g)
        out[:, lo:lo + n] = g[:, lo:lo + n]
        return out, None


def gather_from_sp(x: torch.Tensor, tp: Collectives) -> torch.Tensor:
    """The whole sequence from each model rank's block ``x`` (B, S/m,
    ...): one all-gather; backward, one reduce-scatter of the gradient,
    which sums the partial gradients of the column-parallel consumers."""
    return _GatherFromSP.apply(x, tp)


def reduce_scatter_to_sp(x: torch.Tensor, tp: Collectives) -> torch.Tensor:
    """Leave the tensor-parallel region onto the sequence blocks: ``x``'s
    partial sums (B, S, ...) summed over the model ranks, this rank's
    block kept; backward, one all-gather."""
    return _ReduceScatterToSP.apply(x, tp)


def slice_to_sp(x: torch.Tensor, tp: Collectives) -> torch.Tensor:
    """This rank's block of ``x`` (B, S, ...), which every model rank
    holds alike (an input, or what a layer that runs whole computed):
    forward a slice; backward, one all-gather of the blocks' gradients."""
    return _seq(_SliceToEP.apply(_seq(x), tp))


def keep_block_grad(x: torch.Tensor, tp: Collectives) -> torch.Tensor:
    """``x``, gathered rows read by a consumer that computes alike on every
    model rank: its gradient there is whole and alike, so only this
    rank's block of it is passed on, and the reduce-scatter of
    :func:`gather_from_sp` counts it once."""
    return _KeepBlockGrad.apply(x, tp)


def enter_tp(x: torch.Tensor, tp: Optional[Collectives], *,
             split: bool = True, gathered: bool = False) -> torch.Tensor:
    """A layer's input ``x`` on the model ranks of ``tp``: ``gathered``
    when the caller all-gathered it from the sequence blocks
    (:func:`gather_from_sp`, whose backward sums the partial gradients),
    else whole on every rank.  ``split``: the consumer is column-parallel
    (its gradient partial on each rank); else it computes alike on every
    rank.  The identity without ``tp``."""
    if tp is None:
        return x
    if gathered:
        return x if split else keep_block_grad(x, tp)
    return copy_to_tp(x, tp) if split else x


def leave_tp(y: torch.Tensor, tp: Optional[Collectives], *,
             split: bool = True, sp: bool = False) -> torch.Tensor:
    """A layer's output ``y`` (B, S, ...) back onto the residual stream:
    with ``sp`` this rank's sequence block (partial sums reduce-scattered
    where ``split``, else the block of a whole result), else whole
    (partial sums all-reduced where ``split``).  The identity without
    ``tp``."""
    if tp is None:
        return y
    if sp:
        return reduce_scatter_to_sp(y, tp) if split else slice_to_sp(y, tp)
    return reduce_from_tp(y, tp) if split else y


# ---------------------------------------------------------------------------
# The expert-parallel region (the EP round under autograd)
# ---------------------------------------------------------------------------


class _SliceToEP(torch.autograd.Function):
    """This rank's block of rows; backward, the blocks' gradients
    all-gathered (each rank's block is the whole gradient of its rows)."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        n = x.shape[0] // ep.size
        return x[ep.rank * n:(ep.rank + 1) * n]

    @staticmethod
    def backward(ctx, g):
        return ctx.ep.all_gather(g), None


class _ExchangeEP(torch.autograd.Function):
    """The lane all-to-all; backward, the same all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, buf, ep):
        ctx.ep = ep
        return ep.all_to_all(buf)

    @staticmethod
    def backward(ctx, g):
        return ctx.ep.all_to_all(g), None


class _GatherFromEP(torch.autograd.Function):
    """Every rank's rows stacked rank-major; backward, this rank's block
    of the gradient, no collective (the loss downstream is replicated)."""

    @staticmethod
    def forward(ctx, y, ep):
        ctx.ep, ctx.n = ep, y.shape[0]
        return ep.all_gather(y)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ep.rank, ctx.n
        return g[r * n:(r + 1) * n], None


def slice_to_ep(x: torch.Tensor, ep: Collectives) -> torch.Tensor:
    """Enter the expert region: rows ``[s·T/S, (s+1)·T/S)`` of ``x`` for
    expert rank ``s`` of ``S``, their gradient all-gathered backward."""
    return _SliceToEP.apply(x, ep)


def exchange_ep(buf: torch.Tensor, ep: Collectives) -> torch.Tensor:
    """The lane all-to-all over ``ep``'s ranks, differentiable."""
    return _ExchangeEP.apply(buf, ep)


def gather_from_ep(y: torch.Tensor, ep: Collectives) -> torch.Tensor:
    """Leave the expert region: the ranks' rows all-gathered; backward,
    this rank's block of the gradient."""
    return _GatherFromEP.apply(y, ep)
