"""Mamba-1 selective scan: wrapper of the CUDA kernel ``csrc/ssm_scan.cu``.

Port of the Pallas kernel ``repro/kernels/ssm_scan/ssm_scan.py``:
``h_t = dA_t ⊙ h_{t−1} + dBx_t``, ``y_t = Σ_n h_t[:, n]·C_t[n]``, all
fp32.  Unlike the Pallas kernel the state may start from ``h0`` and the
last state is returned, so the model can chain its L-chunks.  CPU
tensors run the plain version (:func:`~.ref.ssm_scan_ref`); CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import ssm_scan_ref

#: kernel launches since the last reset (a plain int; callers zero it)
launches = 0

STATE_SIZES = (4, 8, 16)


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> tuple:
    """dA/dBx (B, L, Di, N), C (B, L, N), h0 (B, Di, N) or ``None`` (zero
    state) → ``(y (B, L, Di), h_last (B, Di, N))``, fp32 in and out."""
    global launches
    given = [t for t in (dA, dBx, C, h0) if t is not None]
    if _build.all_on_cpu(*given):
        return ssm_scan_ref(dA, dBx, C, h0)
    _build.refuse_grad("ssm_scan", *given)
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
    y = torch.empty((B, L, Di), dtype=torch.float32, device=dA.device)
    h_out = torch.empty((B, Di, N), dtype=torch.float32, device=dA.device)
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    rc = _build.entry("ssm_scan")(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), B, L, Di, N, stream)
    _build.check("ssm_scan", rc)
    launches += 1
    return y, h_out
