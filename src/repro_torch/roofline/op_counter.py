"""Count one traced step's FLOPs, bytes and collectives on the meta device.

The counterpart of ``repro/roofline/hlo_analyzer.py``, which reads them
from compiled HLO: eager PyTorch runs every aten op as a kernel of its
own, so the sum of the ops' input and output bytes is the step's HBM
traffic (no fusion to discount).  Inside :class:`OpCounter`:

* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls
  and convolutions, forward and backward);
* bytes are, per aten op, the bytes of its tensor inputs and outputs,
  views and allocations (``empty``) excluded;
* the hand-written kernels, which on meta tensors launch nothing, report
  their own FLOPs and bytes (the formulas behind ``PERF.md``'s bound
  column) through :mod:`.sink`, per kernel name;
* the counted collectives (:class:`~repro_torch.distributed.comm.
  Collectives`) report each call's kind and result bytes there too.

Nothing here needs the card: on meta tensors the step allocates nothing
and launches nothing.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from . import sink
from .analysis import OpCost

aten = torch.ops.aten
#: ops that allocate or describe and move no bytes
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _ByteMode(TorchDispatchMode):
    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _FREE:
            self.counter.cost.bytes += _nbytes((args, kwargs)) \
                + _nbytes(out)
        return out


class OpCounter:
    """Context manager counting what runs inside it into :attr:`cost` (an
    :class:`~.analysis.OpCost`: ``flops``, ``bytes``, ``coll_count`` and
    ``coll_bytes`` by kind) and the kernels' calls, FLOPs and bytes by
    name into :attr:`kernels`."""

    def __init__(self):
        self.cost = OpCost()
        self.kernels: dict = {}

    def __enter__(self) -> "OpCounter":
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteMode(self)
        self._flops.__enter__()
        self._bytes.__enter__()
        sink.push(self)
        return self

    def __exit__(self, *exc):
        sink.pop(self)
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.cost.flops += float(self._flops.get_total_flops())
        return False

    def on_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def on_collective(self, kind: str, nbytes: int) -> None:
        c = self.cost
        c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + nbytes
