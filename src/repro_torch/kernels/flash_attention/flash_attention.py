"""Forward GQA flash attention: wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention/flash_attention.py``:
online softmax in fp32, causal and optional sliding-window masks, the KV
loop bounded per query tile to the key blocks that meet the triangle or
band.  bf16 runs on the tensor cores, fp32 on the CUDA cores; both take
every head dim that is a multiple of 16 up to 128.  CPU tensors run the
plain version (:func:`~.ref.attention_ref`); CUDA tensors launch the
kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

#: kernel launches since the last reset (a plain int; callers zero it)
launches = 0

#: the head dims the kernel is built for: multiples of 16 (the bf16 k16
#: step and 16-byte loads) up to 128
HEAD_DIMS = tuple(range(16, 129, 16))
MAX_GROUP = 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, T, KV, dh) → (B, S, H, dh) in q's dtype.
    Query and key positions both start at 0."""
    global launches
    if _build.all_on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    _build.refuse_grad("flash_attention", q, k, v)
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
        raise ValueError(f"flash_attention: head dim {dh} is not a multiple "
                         f"of 16 up to 128 (takes {HEAD_DIMS})")
    if code == _build.DTYPE_CODES["torch.bfloat16"] and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 inputs must be 16-byte "
                         "aligned (the kernel loads 16-byte vectors)")
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
