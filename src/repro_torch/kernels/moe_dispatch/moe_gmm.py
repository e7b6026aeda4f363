"""Grouped expert SwiGLU FFN: wrapper of the CUDA kernel ``csrc/moe_gmm.cu``.

Port of the Pallas kernel ``repro/kernels/moe_dispatch/moe_gmm.py``:
``out[e] = (silu(buf[e]·w1[e]) ⊙ (buf[e]·w3[e]))·w2[e]`` over capacity
buffers ``(E, C, d)``.  CPU tensors run the plain version
(:func:`~.ref.moe_gmm_ref`); CUDA tensors launch the kernel or raise.
``launches`` counts kernel launches (one per call on the card).
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import moe_gmm_ref

#: kernel launches since the last reset (a plain int; callers zero it)
launches = 0

#: the kernel keeps four output columns per thread of 256
MAX_D = 1024
MAX_BLOCK_F = 64


def _tile(n: int, cap: int = 128) -> int:
    """Largest block size ≤ cap that divides n (n ≥ 1 ⇒ always exists)."""
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def launch_plan(E: int, C: int, f: int, n_sms: int) -> tuple:
    """(block_c, block_f, f_splits) for a launch: an 8-row C tile when the
    capacity fits it (decode), else 16; the widest f-block ≤ 64 dividing
    f; and the f range split in two until the grid covers the SMs twice
    (splits must divide the f-block count)."""
    block_c = 8 if C <= 8 else 16
    block_f = _tile(f, MAX_BLOCK_F)
    nf = f // block_f
    tiles = -(-C // block_c)
    splits = 1
    while E * tiles * splits < 2 * n_sms and nf % (2 * splits) == 0:
        splits *= 2
    return block_c, block_f, splits


def moe_gmm(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d); w1/w3 (E, d, f); w2 (E, f, d) → (E, C, d) in buf's
    dtype, fp32 inside."""
    global launches
    if _build.all_on_cpu(buf, w1, w3, w2):
        return moe_gmm_ref(buf, w1, w3, w2)
    code = _build.cuda_inputs("moe_gmm", buf, w1, w3, w2)
    E, C, d = buf.shape
    f = w1.shape[-1]
    if w1.shape != (E, d, f) or w3.shape != (E, d, f) or w2.shape != (E, f, d):
        raise ValueError(f"moe_gmm: shapes buf {tuple(buf.shape)} w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)} do not agree")
    if d > MAX_D:
        raise ValueError(f"moe_gmm: d={d} exceeds the kernel's {MAX_D}")
    out = torch.empty_like(buf)
    if buf.numel() == 0:
        return out
    n_sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    block_c, block_f, splits = launch_plan(E, C, f, n_sms)
    scratch = (torch.empty(splits * E * C * d, dtype=torch.float32,
                           device=buf.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = _build.entry("moe_gmm")(
        buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        E, C, d, f, block_c, block_f, splits, code, stream)
    _build.check("moe_gmm", rc)
    launches += 1
    return out
