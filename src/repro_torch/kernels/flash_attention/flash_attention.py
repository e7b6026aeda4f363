"""GQA flash attention and its gradient: wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

Port of the Pallas kernel ``repro/kernels/flash_attention/flash_attention.py``:
online softmax in fp32, causal and optional sliding-window masks, the KV
loop bounded per query tile to the key blocks that meet the triangle or
band.  bf16 runs on the tensor cores, fp32 on the CUDA cores; both take
every head dim that is a multiple of 16 up to 128.  CPU tensors run the
plain version (:func:`~.ref.attention_ref`, which autograd differentiates);
CUDA tensors launch the kernel or raise; meta tensors (the dry run)
return empty outputs and report the kernel's cost to the active op
counter (:mod:`repro_torch.roofline.sink`).  On CUDA tensors in grad mode
the call goes through :class:`FlashAttentionFn`: the forward also writes
each row's log-sum-exp, and the backward launches the backward kernels
(dq with the row sums ``D = rowsum(dO ⊙ O)``, then dk/dv, no atomics;
bf16 on the tensor cores, fp32 on the CUDA cores).
``launches`` counts forward launches, ``bwd_launches`` backward ones.
"""

from __future__ import annotations

import torch

from .. import _build
from ...roofline import sink
from .ref import attention_ref

#: kernel launches since the last reset (plain ints; callers zero them)
launches = 0
bwd_launches = 0

#: the head dims the kernel is built for: multiples of 16 (the bf16 k16
#: step and 16-byte loads) up to 128
HEAD_DIMS = tuple(range(16, 129, 16))
MAX_GROUP = 64


def _check(q, k, v) -> int:
    """Validate CUDA inputs; return the kernel's dtype code."""
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
    return code


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave, per batch row and head
    (query and key positions from 0)."""
    qp = torch.arange(S, dtype=torch.int64)
    hi = torch.clamp(qp + 1, max=T) if causal else torch.full_like(qp, T)
    lo = torch.clamp(qp - window + 1, min=0) if window > 0 \
        else torch.zeros_like(qp)
    return int(torch.clamp(hi - lo, min=0).sum())


def _cost(q, k, causal: bool, window: int, per_pair: int) -> float:
    """``per_pair``·dh FLOPs per visible pair and head (4 forward: two
    matmuls; 10 backward: five)."""
    B, S, H, dh = q.shape
    return float(per_pair * dh * B * H
                 * visible_pairs(S, k.shape[1], causal, window))


def _forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """Launch the forward kernel; returns ``(out, lse or None)``."""
    global launches
    if _build.all_on_meta(q, k, v):
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32, device=q.device) \
            if with_lse else None
        sink.kernel("flash_attention", _cost(q, k, causal, window, 4),
                    _build.nbytes(q, k, v, out, lse))
        return out, lse
    code = _check(q, k, v)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.numel() == 0 or k.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, S, T, H, KV, dh, int(bool(causal)), int(window), code, stream)
    _build.check("flash_attention", rc)
    launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0) -> tuple:
    """Launch the backward kernels: ``(dq, dk, dv)`` in q's dtype from the
    forward's inputs, its output ``out`` and row log-sum-exp ``lse`` (B,
    H, S) and ``dout`` = dL/dout."""
    global bwd_launches
    if _build.all_on_meta(q, k, v, out, lse, dout):
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        sink.kernel("flash_attention_bwd", _cost(q, k, causal, window, 10),
                    _build.nbytes(q, k, v, out, lse, dout, *grads))
        return grads
    code = _check(q, k, v)
    _build.cuda_inputs("flash_attention", q, out, dout)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (
            q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: out/dout must match q and lse "
                         "be fp32 (B, H, S)")
    if code == _build.DTYPE_CODES["torch.bfloat16"] and any(
            t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention_bwd: bf16 out/dout must be 16-byte "
                         "aligned (the kernels load 16-byte vectors)")
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, dh,
        int(bool(causal)), int(window), code, stream)
    _build.check("flash_attention_bwd", rc)
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel pair under autograd: the forward saves q, k, v, the output
    and its row log-sum-exp; the backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, T, KV, dh) → (B, S, H, dh) in q's dtype.
    Query and key positions both start at 0.  Differentiable on both
    devices."""
    if _build.all_on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    if _build.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window))
    return _forward(q, k, v, causal, window, with_lse=False)[0]
