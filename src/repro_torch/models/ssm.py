"""Mamba-1 selective SSM block (falcon-mamba / hymba mamba heads).

Port of ``repro/models/ssm.py``.  The reference scans each sequence chunk
with a parallel ``associative_scan`` and carries the ``(Di, N)`` state
across chunks with ``lax.scan``; here every chunk goes to the selective
scan kernel (``kernels/ssm_scan``), which takes the carried state as
``h0`` and returns the next one.  The reference's tests hold its chunked
scan equal to the Pallas kernel.  ``(dA, dBx, C)`` — ``(B, chunk, Di, N)``
fp32, 2·N× the activation size — are still built one chunk at a time, so
the forward's working set is the reference's; in training the chunks
differentiate end to end through the kernel's backward (the gradient of
each chunk's last state flows into the previous chunk), and autograd keeps
every chunk's ``dA`` and ``dBx`` where the reference rematerialises them.
Decode updates the layer's ``conv``/``h`` cache IN PLACE.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan.ops import ssm_scan_op
from .layers import _norm_init, dense_apply, dense_init


def ssm_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's distributions; ``A_log = log(1..N)`` per channel and
    ``D = 1`` are fp32 whatever the model dtype."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, cw = cfg.dt_rank, cfg.conv_width
    dev = gen.device
    A = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return {
        "in_proj": dense_init(gen, d, 2 * di, False, dtype),
        "conv_w": _norm_init(gen, (cw, di), cw ** -0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * n, False, dtype),
        "dt_proj": dense_init(gen, dtr, di, True, dtype),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, False, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv over time in fp32.  x (B, L, Di); w (cw, Di);
    state (B, cw-1, Di): the trailing inputs of the previous step (decode).
    Returns ``(y in x.dtype, new_state)``; the new state is taken from the
    padded input, a fresh tensor, so the caller may write it over
    ``state``."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+cw-1, Di)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + x.shape[1]].float() * w[i].float()
    y = y + b.float()
    return y.to(x.dtype), xp[:, xp.shape[1] - (cw - 1):]


def _ssm_params(p: dict, cfg, x: torch.Tensor) -> tuple:
    """Input-dependent (dt, B, C) and the discretised ``(dA, dBx)`` (…, Di,
    N) fp32, with ``C`` (…, N) fp32."""
    dtr, n = cfg.dt_rank, cfg.ssm_state
    dbc = dense_apply(p["x_proj"], x)  # (..., dtr + 2n)
    dt, Bc, Cc = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = F.softplus(dense_apply(p["dt_proj"], dt).float())
    A = -torch.exp(p["A_log"])  # (Di, N)
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * x.float())[..., None] * Bc[..., None, :].float()
    return dA, dBx, Cc.float()


def ssm_scan_chunked(p: dict, cfg, x: torch.Tensor,
                     chunk: int = 256) -> torch.Tensor:
    """Selective scan over (B, L, Di) input, one ``ssm_scan`` launch per
    ``chunk`` steps carrying the state.  Returns (B, L, Di) fp32 with the
    ``x·D`` skip added."""
    L = x.shape[1]
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"scan chunk {chunk}")
    h = None
    ys = []
    for c0 in range(0, L, chunk):
        dA, dBx, Cc = _ssm_params(p, cfg, x[:, c0:c0 + chunk])
        y, h = ssm_scan_op(dA, dBx, Cc.contiguous(), h)
        ys.append(y)
    return torch.cat(ys, dim=1) + x.float() * p["D"]


def ssm_apply(p: dict, cfg, x: torch.Tensor, chunk: int = 256
              ) -> torch.Tensor:
    """Full mamba block: in_proj → conv → selective scan → gate → out."""
    xi, z = torch.chunk(dense_apply(p["in_proj"], x), 2, dim=-1)
    xi, _ = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi)
    y = ssm_scan_chunked(p, cfg, xi, chunk=chunk)
    y = y * F.silu(z.float())
    return dense_apply(p["out_proj"], y.to(x.dtype))


# ---------------------------------------------------------------------------
# Decode (O(1) per token)
# ---------------------------------------------------------------------------


def ssm_decode_apply(p: dict, cfg, x: torch.Tensor, cache: dict) -> tuple:
    """x (B, 1, D); ``cache`` holds this layer's ``conv`` and ``h``, which
    are updated IN PLACE.  Returns ``(y (B, 1, D), cache)``."""
    xi, z = torch.chunk(dense_apply(p["in_proj"], x), 2, dim=-1)
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    xi = F.silu(xi)
    dA, dBx, Cc = _ssm_params(p, cfg, xi[:, 0])  # (B, Di, N), (B, N)
    h = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cc) + xi[:, 0].float() * p["D"]
    y = y * F.silu(z[:, 0].float())
    out = dense_apply(p["out_proj"], y.to(x.dtype))[:, None]
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return out, cache
