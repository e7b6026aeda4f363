"""Plain PyTorch reference of the benchmark's decoder configurations:
what every family shares.

Float32 throughout, TF32 off, no kernel, no cache and no batching: the
published block written out as tensor operations.  A family's own block
is ``portbench/reference/<family>.py``, found by the configuration's
``family``; it gives ``forward`` (a decoder-only family builds it from
:func:`decoder_forward` and its ``block``).  Shared here: RMSNorm,
causal GQA attention with split-half RoPE (windowed where the
configuration says), the decoder stack, the head and the loss.

``quant`` (the control): a function applied to both operands of every
matrix product whose weights the configuration serves in its low
precision (not the fp32 router) and to the residual stream between
layers, with the gradient entering each product's backward rounded too;
it stands for computing one precision lower.  Nothing here imports the
program under test.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def setup_precision() -> None:
    """Full float32 products: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` under one per-tensor scale (its largest
    magnitude maps to ``top``), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand in float8 e4m3.  Backward: the gradient passes
    through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: identity.  Backward: the gradient of a product's output in
    float8 e5m2, as the backward products of fp8 training take it."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """The control's operand rounding: float8 e4m3 (per-tensor scale)."""
    return _Fp8.apply(x)


def _mm(a, b, quant):
    if quant is None:
        return a @ b
    y = quant(a) @ quant(b)
    return _Fp8Grad.apply(y) if torch.is_grad_enabled() else y


def rmsnorm(x, scale, eps=1e-5):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """Split-half rotary embedding; x (B, S, H, dh), pos (B, S) or (S,)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p, model, x, quant):
    B, S, _ = x.shape
    H, KV = model["n_heads"], model["n_kv_heads"]
    dh = model.get("d_head") or model["d_model"] // H
    q = _mm(x, p["wq"]["w"], quant).view(B, S, H, dh)
    k = _mm(x, p["wk"]["w"], quant).view(B, S, KV, dh)
    v = _mm(x, p["wv"]["w"], quant).view(B, S, KV, dh)
    pos = torch.arange(S, device=x.device)
    theta = model.get("rope_theta", 10000.0)
    if theta > 0:
        q, k = rope(q, pos, theta), rope(k, pos, theta)
    G = H // KV
    q = q.view(B, S, KV, G, dh).permute(0, 2, 3, 1, 4)      # B KV G S dh
    k = k.permute(0, 2, 1, 3)[:, :, None]                    # B KV 1 S dh
    v = v.permute(0, 2, 1, 3)[:, :, None]
    s = _mm(q, k.transpose(-1, -2), quant) * dh ** -0.5      # B KV G S S
    i, j = pos[:, None], pos[None, :]
    mask = j <= i
    if model.get("sliding_window", 0) > 0:
        mask = mask & (i - j < model["sliding_window"])
    s = torch.where(mask, s, NEG)
    o = _mm(torch.softmax(s, -1), v, quant)                  # B KV G S dh
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * dh)
    return _mm(o, p["wo"]["w"], quant)


def _layer(stack, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def family(model: dict):
    """The reference module of the configuration's family."""
    return importlib.import_module(f"{__package__}.{model['family']}")


def decoder_forward(block, w, model, tokens, quant=None,
                    capacity_factor=None, remat=False):
    """Logits (B, S, Vp) in float32 of ``tokens`` (B, S) through the
    decoder stack of ``block(p, model, x, quant, capacity_factor)``.  With
    ``quant`` the residual stream is kept in that precision too, as the
    program keeps it in its dtype between layers."""
    keep = quant if quant is not None else (lambda t: t)
    x = keep(w["embed"][tokens])
    for i in range(model["n_layers"]):
        p = _layer(w["layers"], i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, p, model, x, quant, capacity_factor,
                           use_reentrant=False)
        else:
            x = block(p, model, x, quant, capacity_factor)
        x = keep(x)
    x = rmsnorm(x, w["final_norm"]["scale"])
    return _mm(x, w["lm_head"], quant)


def forward(w, model, tokens, quant=None, capacity_factor=None,
            remat=False):
    """The family's logits (B, S, Vp) in float32; ``capacity_factor``
    None serves every routed pair."""
    return family(model).forward(w, model, tokens, quant, capacity_factor,
                                 remat)


def loss(w, model, tokens, labels, quant=None, capacity_factor=None):
    """Mean next-token cross entropy over the real vocabulary."""
    logits = forward(w, model, tokens, quant, capacity_factor, remat=True)
    V = model["vocab"]
    logits = logits.masked_fill(
        torch.arange(logits.shape[-1], device=logits.device) >= V, NEG)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
