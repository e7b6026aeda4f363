"""Roofline terms of one traced step on an NVIDIA H100.

Port of ``repro/roofline/analysis.py`` with the H100's figures in place
of the reference's chip (each constant's source beside it):

    compute    = FLOPs_per_device / 989e12    (bf16 dense tensor cores)
    memory     = bytes_per_device / 3.35e12   (HBM3)
    collective = collective_bytes_per_device / 450e9   (NVLink, one way)

The counts are per device already (one rank's step, traced on the meta
device), so ``X / (chips × BW)`` with global X is ``X_per_device / BW``.
:class:`RooflineTerms`, :func:`roofline_from_opcost`,
:func:`roofline_fraction` and :func:`model_flops_estimate` are the
reference's; its HLO text parsers have no counterpart (the op counter,
:mod:`.op_counter`, counts collectives where they are issued).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

#: H100 SXM5 80GB data sheet, dense (no sparsity), per device
PEAK_FLOPS = 989e12            # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989e12,        # tensor cores, bf16
    "float32": 67e12,          # CUDA cores, fp32
    "tf32": 495e12,            # tensor cores, TF32
}
HBM_BW = 3.35e12               # bytes/s, HBM3
NVLINK_BW = 450e9              # bytes/s per direction, NVLink 4 (18 links)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time the card could
    take to move ``nbytes`` through HBM and do ``flops`` operations of
    ``dtype`` (a key of :data:`PEAK_FLOPS_BY_DTYPE`), and which of the
    two sets it."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS_BY_DTYPE[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass
class OpCost:
    """The reference's ``hlo_analyzer.OpCost``: FLOPs, bytes, and the
    collectives' payload bytes and counts by kind."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_count.items():
            self.coll_count[k] = self.coll_count.get(k, 0.0) + v * mult

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def total_coll_count(self) -> float:
        return sum(self.coll_count.values())

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OpCost":
        return cls(**{k: d[k] for k in ("flops", "bytes", "coll_bytes",
                                        "coll_count")})


@dataclass
class RooflineTerms:
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_bytes_per_device: float = 0.0
    collective_ops: int = 0
    collective_by_kind: dict = field(default_factory=dict)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0          # 6·N·D (·N_active for MoE)
    useful_flops_ratio: float = 0.0   # model / (counted × chips)
    chips: int = 0

    def as_dict(self):
        return asdict(self)


def roofline_from_opcost(opcost, *, chips: int,
                         model_flops: float = 0.0) -> RooflineTerms:
    """Roofline terms from one device's counted step."""
    t = RooflineTerms(chips=chips)
    t.flops_per_device = float(opcost.flops)
    t.bytes_per_device = float(opcost.bytes)
    t.collective_by_kind = {
        k: {"count": opcost.coll_count.get(k, 0.0),
            "bytes": opcost.coll_bytes.get(k, 0.0)}
        for k in set(opcost.coll_count) | set(opcost.coll_bytes)
    }
    t.collective_bytes_per_device = float(opcost.total_coll_bytes)
    t.collective_ops = int(opcost.total_coll_count)
    t.compute_s = t.flops_per_device / PEAK_FLOPS
    t.memory_s = t.bytes_per_device / HBM_BW
    t.collective_s = t.collective_bytes_per_device / NVLINK_BW
    terms = {"compute": t.compute_s, "memory": t.memory_s,
             "collective": t.collective_s}
    t.dominant = max(terms, key=terms.get)
    t.model_flops = model_flops
    total_hlo = t.flops_per_device * chips
    t.useful_flops_ratio = (model_flops / total_hlo) if total_hlo else 0.0
    return t


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D with N = active params; D = tokens processed by the step."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_fraction(t: RooflineTerms) -> float:
    """Fraction of the roofline bound the useful model FLOPs achieve:
    (model_flops / chips / peak) / max(term)."""
    bound = max(t.compute_s, t.memory_s, t.collective_s)
    if bound <= 0 or t.chips == 0:
        return 0.0
    useful_s = t.model_flops / t.chips / PEAK_FLOPS
    return useful_s / bound
