"""Counted collectives over one process group.

The reference counts its collectives in the compiled HLO
(``roofline.analysis.collective_stats``); the port issues them eagerly, so
it counts them where it issues them: every method of :class:`Collectives`
makes one ``torch.distributed`` call and adds one to its kind's count.
A train step makes one :class:`Collectives` per call and returns its
``counts`` in the step's metrics; the EP round makes one per round.

All reductions are sums (gloo has no average); callers divide.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
         "send_recv")


def mesh_group(mesh, axis=None):
    """The process group of ``axis`` of ``mesh``, or with ``axis=None``
    of the whole mesh: its one axis larger than 1, or the default group
    when the mesh spans the world."""
    if axis is not None:
        return mesh.get_group(axis)
    names = mesh.mesh_dim_names
    wide = [a for a, n in zip(names, tuple(mesh.shape)) if n > 1]
    if len(wide) <= 1:
        return mesh.get_group(wide[0] if wide else names[0])
    if sorted(mesh.mesh.flatten().tolist()) != \
            list(range(dist.get_world_size())):
        raise NotImplementedError(
            f"a group over the mesh axes {wide} of a mesh that does not "
            "span the world")
    return dist.group.WORLD


class Collectives:
    """One group's collectives, counted by kind in :attr:`counts`."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.counts = dict.fromkeys(KINDS, 0)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns ``t``."""
        dist.all_reduce(t, group=self.group)
        self.counts["all_reduce"] += 1
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group and return this rank's block of its
        leading dim (a multiple of the group size)."""
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        self.counts["reduce_scatter"] += 1
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along the leading dim, rank-major."""
        out = t.new_empty((t.shape[0] * self.size, *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        self.counts["all_gather"] += 1
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of ``t``'s leading dim goes to rank ``j``; block
        ``i`` of the result came from rank ``i``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        self.counts["all_to_all"] += 1
        return out

    def send_recv(self, send: torch.Tensor, dst: int, recv: torch.Tensor,
                  src: int) -> None:
        """One ring hop: ``send`` to group rank ``dst`` while ``recv``
        (contiguous, written in place) arrives from group rank ``src``."""
        ranks = dist.get_process_group_ranks(self.group)
        ops = [dist.P2POp(dist.isend, send.contiguous(), ranks[dst],
                          self.group),
               dist.P2POp(dist.irecv, recv, ranks[src], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.counts["send_recv"] += 1
