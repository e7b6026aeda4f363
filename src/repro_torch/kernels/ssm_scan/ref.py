"""Plain PyTorch version of the selective-scan kernel."""

from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> tuple:
    """dA/dBx (B, L, Di, N); C (B, L, N); h0 (B, Di, N) or ``None`` (zero
    state) → ``(y (B, L, Di), h_last (B, Di, N))``, both fp32.

    A sequential loop over L: ``h = dA_t·h + dBx_t``, ``y_t = Σ_n h·C_t``."""
    B, L, Di, N = dA.shape
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=dA.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(L):
        h = dA[:, t].float() * h + dBx[:, t].float()
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t].float()))
    return torch.stack(ys, dim=1), h
