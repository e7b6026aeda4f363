"""Mamba-1 selective scan and its gradient: wrappers of the CUDA kernels
in ``csrc/ssm_scan.cu`` (``ssm_scan_launch`` and ``ssm_scan_bwd_launch``).

Port of the Pallas kernel ``repro/kernels/ssm_scan/ssm_scan.py``:
``h_t = dA_t ⊙ h_{t−1} + dBx_t``, ``y_t = Σ_n h_t[:, n]·C_t[n]``, all
fp32.  Unlike the Pallas kernel the state may start from ``h0`` and the
last state is returned, so the model can chain its L-chunks.  CPU
tensors run the plain version (:func:`~.ref.ssm_scan_ref`, which autograd
differentiates); CUDA tensors launch the kernel or raise.  On CUDA
tensors in grad mode the call goes through :class:`SsmScanFn`, whose
backward launches the backward kernel (the states recomputed and kept on
chip inside the launch, under :func:`bwd_plan`, ``dC`` summed over
channels without atomics); the gradient of
``h_last`` flows into the previous chunk, so chained chunks differentiate
end to end.  ``launches`` counts forward launches, ``bwd_launches``
backward ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build
from .ref import ssm_scan_ref

#: kernel launches since the last reset (plain ints; callers zero them)
launches = 0
bwd_launches = 0

STATE_SIZES = (4, 8, 16)

#: the backward's geometry (``kBwdSeg``, ``kBwdCluster``, ``kBwdRows`` in
#: the source): steps of a chunk kept on chip at once, blocks per
#: thread-block cluster (one dC partial each), steps per TMA box
BWD_SEGMENT, BWD_CLUSTER, BWD_ROWS = 256, 8, 32


class BwdPlan(NamedTuple):
    """The backward launch at one shape: ``grid`` blocks of ``threads``
    (one warp: ``channels_per_block`` channels of N state lanes), in
    clusters of ``cluster`` along x; ``segments`` of ``segment`` steps
    (one unless L > ``segment``); ``smem`` bytes of dynamic shared memory
    (dA and h of one segment in whole boxes of ``BWD_ROWS`` steps,
    128-byte rows, and one load barrier per box);
    ``part_shape``, the per-cluster dC partials."""

    threads: int
    channels_per_block: int
    grid: tuple
    cluster: int
    segment: int
    segments: int
    smem: int
    part_shape: tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(B: int, L: int, Di: int, N: int) -> BwdPlan:
    """The geometry of ``ssm_scan_bwd_launch`` (``bwd_blocks`` and
    ``launch_bwd`` in the source compute the same)."""
    cpb = 32 // N
    blocks = _cdiv(_cdiv(Di, cpb), BWD_CLUSTER) * BWD_CLUSTER
    rows = _cdiv(min(L, BWD_SEGMENT), BWD_ROWS) * BWD_ROWS
    smem = 2 * rows * 32 * 4 + 8 * (rows // BWD_ROWS)
    return BwdPlan(32, cpb, (blocks, B), BWD_CLUSTER, BWD_SEGMENT,
                   _cdiv(L, BWD_SEGMENT), smem,
                   (blocks // BWD_CLUSTER, B, L, N))


def _check(dA, dBx, C, h0) -> tuple:
    """Validate CUDA inputs; returns ``(B, L, Di, N)``."""
    given = [t for t in (dA, dBx, C, h0) if t is not None]
    if _build.cuda_inputs("ssm_scan", *given) != 0:
        raise TypeError(f"ssm_scan: the kernel takes float32 only, not "
                        f"{dA.dtype}")
    B, L, Di, N = dA.shape
    if dBx.shape != dA.shape or C.shape != (B, L, N) or (
            h0 is not None and h0.shape != (B, Di, N)):
        raise ValueError(
            f"ssm_scan: dA {tuple(dA.shape)} dBx {tuple(dBx.shape)} C "
            f"{tuple(C.shape)} h0 {None if h0 is None else tuple(h0.shape)} "
            f"do not agree")
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_scan: state size {N} not in {STATE_SIZES}")
    if any(t.data_ptr() % 16 for t in given):
        raise ValueError("ssm_scan: inputs must be 16-byte aligned")
    return B, L, Di, N


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(dA, dBx, C, h0) -> tuple:
    """Launch the forward kernel; returns ``(y, h_last)``."""
    global launches
    B, L, Di, N = _check(dA, dBx, C, h0)
    y = torch.empty((B, L, Di), dtype=torch.float32, device=dA.device)
    h_out = torch.empty((B, Di, N), dtype=torch.float32, device=dA.device)
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    rc = _build.entry("ssm_scan")(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), _ptr(h0), y.data_ptr(),
        h_out.data_ptr(), B, L, Di, N, stream)
    _build.check("ssm_scan", rc)
    launches += 1
    return y, h_out


def ssm_scan_bwd(dA, dBx, C, h0, dy, dh_last=None) -> tuple:
    """Launch the backward kernels: ``(d_dA, d_dBx, dC, dh0)`` from the
    forward's inputs, ``dy`` = dL/dy (B, L, Di) and ``dh_last`` = dL/dh_last
    (B, Di, N) or ``None`` (zero); ``dh0`` is ``None`` when ``h0`` is."""
    global bwd_launches
    B, L, Di, N = _check(dA, dBx, C, h0)
    extra = [t for t in (dy, dh_last) if t is not None]
    _build.cuda_inputs("ssm_scan", dA, *extra)
    if dy.shape != (B, L, Di) or (
            dh_last is not None and dh_last.shape != (B, Di, N)):
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} or dh_last "
                         f"do not match dA {tuple(dA.shape)}")
    if dy.dtype != torch.float32 or any(t.data_ptr() % 16 for t in extra):
        raise ValueError("ssm_scan_bwd: dy and dh_last must be fp32 and "
                         "16-byte aligned")
    d_dA, d_dBx = torch.empty_like(dA), torch.empty_like(dBx)
    dC = torch.empty_like(C)
    dh0 = None if h0 is None else torch.empty_like(h0)
    # per-cluster partial sums of dC, summed in a fixed order by the
    # second kernel (no atomics)
    part = torch.empty(bwd_plan(B, L, Di, N).part_shape,
                       dtype=torch.float32, device=dA.device)
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    rc = _build.entry("ssm_scan_bwd")(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), _ptr(h0), dy.data_ptr(),
        _ptr(dh_last), d_dA.data_ptr(), d_dBx.data_ptr(), dC.data_ptr(),
        _ptr(dh0), part.data_ptr(), B, L, Di, N, stream)
    _build.check("ssm_scan_bwd", rc)
    bwd_launches += 1
    return d_dA, d_dBx, dC, dh0


class SsmScanFn(torch.autograd.Function):
    """The kernel pair under autograd: the forward saves dA, dBx, C and h0
    (nothing else); the backward launches the backward kernel."""

    @staticmethod
    def forward(ctx, dA, dBx, C, h0):
        y, h_out = _forward(dA, dBx, C, h0)
        ctx.save_for_backward(dA, dBx, C, h0)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh_last):
        dA, dBx, C, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dA.shape[:3], dtype=torch.float32,
                             device=dA.device)
        d_dA, d_dBx, dC, dh0 = ssm_scan_bwd(
            dA, dBx, C, h0, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous())
        return d_dA, d_dBx, dC, dh0


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> tuple:
    """dA/dBx (B, L, Di, N), C (B, L, N), h0 (B, Di, N) or ``None`` (zero
    state) → ``(y (B, L, Di), h_last (B, Di, N))``, fp32 in and out.
    Differentiable on both devices."""
    given = [t for t in (dA, dBx, C, h0) if t is not None]
    if _build.all_on_cpu(*given):
        return ssm_scan_ref(dA, dBx, C, h0)
    if _build.needs_grad(*given):
        return SsmScanFn.apply(dA, dBx, C, h0)
    return _forward(dA, dBx, C, h0)
