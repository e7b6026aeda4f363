"""What the model calls for whole-sequence attention.

The reference's ``ops.py`` jits the Pallas kernel and picks interpret
mode off the TPU; here the wrapper itself picks the plain version for CPU
tensors and the CUDA kernel for CUDA tensors, so the op is the wrapper.
"""

from __future__ import annotations

from .flash_attention import flash_attention


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    return flash_attention(q, k, v, causal=causal, window=window)
