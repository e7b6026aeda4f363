"""Plain PyTorch versions of the selective-scan kernel and its gradient."""

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


def ssm_scan_bwd_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                     h0: Optional[torch.Tensor], dy: torch.Tensor,
                     dh_last: Optional[torch.Tensor] = None) -> tuple:
    """The gradient of :func:`ssm_scan_ref`: from its inputs, ``dy`` =
    dL/dy (B, L, Di) and ``dh_last`` = dL/dh_last (B, Di, N) or ``None``
    (zero) → ``(d_dA, d_dBx, dC, dh0)`` in the inputs' shapes, fp32.

    The states are recomputed forward; then the carried state gradient
    runs back, ``g_t = dy_t[d]·C_t[n] + dA_{t+1} ⊙ g_{t+1}`` (``g`` after
    step L - 1 is ``dh_last``), with ``d_dBx_t = g_t``, ``d_dA_t = g_t ⊙
    h_{t-1}`` (``h_{-1} = h0``), ``dC_t = Σ_d dy_t[d]·h_t[d, :]`` and
    ``dh0 = dA_0 ⊙ g_0``."""
    B, L, Di, N = dA.shape
    dA, C, dy = dA.float(), C.float(), dy.float()
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=dA.device) \
        if h0 is None else h0.float()
    hs = [h]
    for t in range(L):
        h = dA[:, t] * h + dBx[:, t].float()
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float().clone()
    d_dA, d_dBx = torch.empty_like(dA), torch.empty_like(dA)
    dC = torch.empty_like(C)
    for t in range(L - 1, -1, -1):
        g = g + dy[:, t, :, None] * C[:, t, None, :]
        d_dBx[:, t] = g
        d_dA[:, t] = g * hs[t]
        dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        g = dA[:, t] * g
    return d_dA, d_dBx, dC, g
