"""Forward GQA flash attention: wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention/flash_attention.py``:
online softmax in fp32, causal and optional sliding-window masks, the KV
loop bounded per query tile to the key blocks that meet the triangle or
band.  CPU tensors run the plain version (:func:`~.ref.attention_ref`);
CUDA tensors launch the kernel or raise.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

#: kernel launches since the last reset (a plain int; callers zero it)
launches = 0

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, T, KV, dh) → (B, S, H, dh) in q's dtype.
    Query and key positions both start at 0."""
    global launches
    if _build.all_on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    code = _build.cuda_inputs("flash_attention", q, k, v)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != (B, T, KV, dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not agree")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"flash_attention: H={H} KV={KV} needs KV | H and "
                         f"H/KV <= {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, dh, int(bool(causal)), int(window), code, stream)
    _build.check("flash_attention", rc)
    launches += 1
    return out
