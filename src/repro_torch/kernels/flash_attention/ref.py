"""Plain PyTorch version of the flash-attention kernel."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,dh); k/v: (B,T,KV,dh) — naive full-matrix softmax in
    fp32, result in q's dtype."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.float()) * dh ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, dh).to(q.dtype)
