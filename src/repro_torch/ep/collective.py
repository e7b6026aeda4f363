"""Token exchange collectives over the ``expert`` mesh axis.

Port of ``repro/ep/collective.py``.  The exchange moves capacity-padded
lane buffers between expert shards: every shard holds a ``(S ·
lane_capacity, ...)`` buffer whose block ``j`` is its outgoing lane for
shard ``j``; after the exchange, block ``i`` of the result is the lane
*from* source ``i``.  Ragged per-shard counts are absorbed by the padding
(the :mod:`repro_torch.ep.plan` arithmetic bounds every lane by
``lane_capacity``), so the collective is one static-shape
``all_to_all_single`` over the expert group — or an equivalent ring of
``batch_isend_irecv`` hops.  The reference runs both inside a
``shard_map``; here every expert shard is a process and ``comm`` (a
:class:`~repro_torch.distributed.comm.Collectives` over the expert group)
issues and counts the calls.

Both are differentiable: the exchange is a permutation of lane blocks
that is its own inverse, so its backward is the same exchange of the
gradient (one more ``all_to_all``, or one more ring).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.comm import exchange_ep
# distributed.sharding owns both the axis name and "does this mesh
# carve it, how wide" (expert_axis_size: 0 when absent); re-exported
# here so EP callers have one import surface.
from ..distributed.sharding import (  # noqa: F401
    EXPERT_AXIS, expert_axis_size,
)


def has_expert_axis(mesh) -> bool:
    return mesh is not None and EXPERT_AXIS in mesh.mesh_dim_names


def exchange(buf: torch.Tensor, n_shards: int, *, comm,
             impl: str = "all_to_all") -> torch.Tensor:
    """All-to-all the lane blocks of ``buf`` (leading dim ``S·C``).

    Outgoing block ``j`` (rows ``[j·C, (j+1)·C)``) goes to shard ``j``;
    incoming block ``i`` of the result came from source ``i``.  Applying
    it twice returns every row home, which is how the combine leg reuses
    it.

    ``impl="all_to_all"`` — one ``all_to_all_single``;
    ``impl="ppermute"`` — an ``S - 1``-step rotation ring (one
    ``batch_isend_irecv`` per step) that moves identical bytes.
    Backward, the same exchange runs on the gradient.
    """
    if buf.shape[0] % n_shards != 0:
        raise ValueError(
            f"lane buffer dim {buf.shape[0]} not divisible by "
            f"{n_shards} shards")
    if impl == "all_to_all":
        return exchange_ep(buf, comm)
    if impl == "ppermute":
        return _Ring.apply(buf, n_shards, comm)
    raise ValueError(f"unknown exchange impl {impl!r}; "
                     "choose all_to_all or ppermute")


def _exchange_ppermute(buf: torch.Tensor, n_shards: int,
                       comm) -> torch.Tensor:
    """Rotation-ring all-to-all: at offset ``o`` every shard sends the
    block addressed to ``(me + o) % S`` and files what arrives under its
    source ``(me - o) % S``.  Block ``me`` (``o = 0``) stays home."""
    S = n_shards
    C = buf.shape[0] // S
    me = comm.rank
    buf = buf.contiguous()
    out = torch.zeros_like(buf)
    out[me * C:(me + 1) * C] = buf[me * C:(me + 1) * C]
    for o in range(1, S):
        dst, src = (me + o) % S, (me - o) % S
        comm.send_recv(buf[dst * C:(dst + 1) * C], dst,
                       out[src * C:(src + 1) * C], src)
    return out


class _Ring(torch.autograd.Function):
    """The rotation ring; backward, the ring on the gradient (the
    exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, buf, n_shards, comm):
        ctx.n_shards, ctx.comm = n_shards, comm
        return _exchange_ppermute(buf, n_shards, comm)

    @staticmethod
    def backward(ctx, g):
        return _exchange_ppermute(g, ctx.n_shards, ctx.comm), None, None


def token_shards(T: int, E: int, mesh) -> Optional[int]:
    """How many ways the EP path can shard this call, or ``None`` when
    the mesh has no expert axis or the shapes don't divide (callers fall
    back to the single-host dispatch rather than mis-shard)."""
    S = expert_axis_size(mesh)
    if S <= 1 or T % S != 0 or E % S != 0:
        return None
    return S
