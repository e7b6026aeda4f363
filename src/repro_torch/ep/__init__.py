"""repro_torch.ep — expert-parallel all-to-all dispatch.

Port of ``repro.ep`` onto ``torch.distributed``:

* :mod:`repro_torch.ep.plan` — **DLBC as exchange planning** (a verbatim
  copy of the reference's host-side planner): the all-to-all send/recv
  count matrix built from router assignments with the canonical
  ``chunk_plan`` arithmetic.
* :mod:`repro_torch.ep.collective` — the token exchange over the expert
  group: capacity-padded lane buffers through one ``all_to_all_single``
  (or a ring of ``batch_isend_irecv`` hops).
* :mod:`repro_torch.ep.dispatch` — **AFE as the round barrier**:
  ``ep_dispatch_combine`` (shard-local route → all-to-all → per-shard
  expert FFN, ``moe_gmm`` on the card → all-to-all combine), and
  ``ep_round``, which runs it under a DCAFE ``FinishScope`` so telemetry
  shows ``joins == rounds``.

Consumers: ``repro_torch.models.moe.moe_apply`` takes this path when the
config sets ``expert_parallel`` and the current mesh carves an expert
axis larger than 1 that divides E.
"""

from .collective import (  # noqa: F401
    EXPERT_AXIS, exchange, expert_axis_size, has_expert_axis, token_shards,
)
from .plan import ExchangePlan, lane_capacity, plan_exchange  # noqa: F401
from .dispatch import ep_dispatch_combine, ep_round  # noqa: F401
