"""Core NN layers: norms, RoPE, linear, MLP, attention and KV-cache writes.

Port of ``repro/models/layers.py``: self attention, and cross attention
for the encoder-decoder and vision-language families.  Params are plain
dicts of tensors with the reference's layouts
(``(d_in, d_out)`` weights, ``(B, S, H, dh)`` activations, ``(B, T, KV,
dh)`` caches).  Differences from the reference:

* whole-sequence attention (:func:`attn_apply`) goes through the
  flash-attention kernel wrapper instead of the XLA ``chunked_attention``
  (the reference's tests hold the two equal); the kernel's per-tile key
  bound is the "tri"/"window" schedule;
* KV-cache writes update the cache tensor IN PLACE and return it;
* sharding constraints are gone (one card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention_op

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Param init (torch-native; same distributions as the reference)
# ---------------------------------------------------------------------------


def _norm_init(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    if gen.device.type == "meta":  # shapes only (model.param_shapes)
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, bias: bool, dtype) -> dict:
    out = {"w": _norm_init(gen, (d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        out["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return out


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms (fp32 accumulation)
# ---------------------------------------------------------------------------


def norm_init(gen, d: int, kind: str, dtype) -> dict:
    out = {"scale": torch.ones((d,), dtype=dtype, device=gen.device)}
    if kind == "layernorm":
        out["bias"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return out


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half)
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, dh); positions: (..., S)."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, f: int, act: str, dtype) -> dict:
    w1 = _norm_init(gen, (d, f), d ** -0.5, dtype)
    if act == "swiglu":
        w3 = _norm_init(gen, (d, f), d ** -0.5, dtype)
        return {"w1": w1, "w3": w3,
                "w2": _norm_init(gen, (f, d), f ** -0.5, dtype)}
    return {"w1": w1, "b1": torch.zeros((f,), dtype=dtype, device=gen.device),
            "w2": _norm_init(gen, (f, d), f ** -0.5, dtype),
            "b2": torch.zeros((d,), dtype=dtype, device=gen.device)}


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _per_row(idx, B: int, device) -> torch.Tensor:
    """Scalar-or-``(B,)`` index → ``(B,)`` int64 tensor on ``device``."""
    idx = torch.as_tensor(idx, device=device).long()
    return idx.expand(B) if idx.ndim == 0 else idx


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, dh)
    k_cache: torch.Tensor,  # (B, T, KV, dh)
    v_cache: torch.Tensor,
    cache_index,            # () or (B,) — valid cache entries
) -> torch.Tensor:
    """One-token attention against a KV cache; ``cache_index`` is a
    scalar (every row at the same position) or per-row ``(B,)``.  (The
    reference's ``window`` argument is not ported: a sliding-window cache
    is a ring buffer whose every valid entry is attended.)"""
    B, _, H, dh = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) \
        * dh ** -0.5
    pos = torch.arange(T, device=q.device)
    ci = _per_row(cache_index, B, q.device)
    mask = pos[None, :] < ci[:, None]                       # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


def attn_init(gen, cfg, dtype) -> dict:
    d, h = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    bias = cfg.qkv_bias
    return {
        "wq": dense_init(gen, d, H * h, bias, dtype),
        "wk": dense_init(gen, d, KV * h, bias, dtype),
        "wv": dense_init(gen, d, KV * h, bias, dtype),
        "wo": dense_init(gen, H * h, d, False, dtype),
    }


def attn_apply(
    p: dict, cfg, x: torch.Tensor, *,
    kv_src: Optional[torch.Tensor] = None,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    schedule: str = "masked",
    q_chunk: int = 1024, k_chunk: int = 1024,
) -> torch.Tensor:
    """Whole-sequence attention through the flash-attention kernel: self
    attention, or cross attention to ``kv_src`` (B, T, d), which gives K
    and V, takes no RoPE and no window and is never causal.

    ``schedule``, ``q_chunk`` and ``k_chunk`` are kept for signature
    parity with the reference and ignored: the kernel bounds each query
    tile's key loop to the blocks that meet the causal triangle or the
    window band, which is the reference's "tri"/"window" schedule."""
    B, S, d = x.shape
    H, KV, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    T = src.shape[1]
    q = dense_apply(p["wq"], x).reshape(B, S, H, h)
    k = dense_apply(p["wk"], src).reshape(B, T, KV, h)
    v = dense_apply(p["wv"], src).reshape(B, T, KV, h)
    if kv_src is None and cfg.rope_theta > 0:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention_op(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal and kv_src is None,
        window=cfg.sliding_window if kv_src is None else 0)
    return dense_apply(p["wo"], out.reshape(B, S, H * h))


def kv_cache_update(cache_arr: torch.Tensor, new: torch.Tensor,
                    idx) -> torch.Tensor:
    """Write a one-token K/V slice ``new`` (B, 1, KV, h) into the cache
    IN PLACE at ``idx`` — a scalar or per-row ``(B,)``.  Like the
    reference, an index past the cache end is clamped to ``T-1``
    (overwrite the last position, never drop).  Returns ``cache_arr``."""
    B, T = cache_arr.shape[0], cache_arr.shape[1]
    idx = torch.clamp(_per_row(idx, B, cache_arr.device), 0, T - 1)
    rows = torch.arange(B, device=cache_arr.device)
    cache_arr[rows, idx] = new[:, 0].to(cache_arr.dtype)
    return cache_arr


def kv_cache_update_span(cache_arr: torch.Tensor, new: torch.Tensor,
                         idx: torch.Tensor, count: torch.Tensor
                         ) -> torch.Tensor:
    """Write a K/V span ``new`` (B, C, KV, h) into the cache IN PLACE,
    starting at per-row indices ``idx`` (B,).  Only the first
    ``count[b]`` lanes of row b are written; padding lanes and lanes that
    would land past the cache end are dropped, so an inert row's cache is
    untouched bit for bit.  (The reference routes such lanes to index
    ``T`` and lets the scatter drop them; ``index_put_`` has no drop
    mode, so the write is masked instead.)  Each cache position takes the
    lane that lands on it, or keeps its value: a gather and a select over
    the row, with no data-dependent shape, so nothing waits for the
    device.  Returns ``cache_arr``."""
    B, T = cache_arr.shape[0], cache_arr.shape[1]
    C = new.shape[1]
    lane = torch.arange(T, device=cache_arr.device)[None, :] \
        - idx.long()[:, None]                                      # (B, T)
    valid = (lane >= 0) & (lane < count.long()[:, None]) & (lane < C)
    src = torch.gather(new.to(cache_arr.dtype), 1,
                       lane.clamp(0, C - 1)[:, :, None, None]
                       .expand(B, T, *new.shape[2:]))
    cache_arr.copy_(torch.where(valid[:, :, None, None], src, cache_arr))
    return cache_arr


def prefill_attention(
    q: torch.Tensor,        # (B, C, H, dh)
    k_cache: torch.Tensor,  # (B, T, KV, dh)
    v_cache: torch.Tensor,
    cache_index: torch.Tensor,  # (B,) absolute position of q[:, 0]
) -> torch.Tensor:
    """Causal attention of a C-token span against the full KV cache.

    Query ``j`` of row ``b`` sits at position ``cache_index[b] + j`` and
    sees every cache position ``<=`` its own.  Every query reduces over
    the same full ``(dh, T)`` axes wherever the chunk boundary falls, on
    the same static shape, so chunked prefill is bitwise equal to
    whole-prompt prefill.  Kept as plain tensor code on purpose: a
    block-bounded flash loop would change the reduction per chunking.
    Padded lanes produce garbage that callers never read."""
    B, C, H, dh = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, C, KV, G, dh)
    s = torch.einsum("bckgd,btkd->bckgt", qg.float(), k_cache.float()) \
        * dh ** -0.5
    qpos = cache_index.long()[:, None] \
        + torch.arange(C, device=q.device)[None, :]                # (B, C)
    mask = torch.arange(T, device=q.device)[None, None, :] <= qpos[..., None]
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, C, H, dh).to(q.dtype)


def attn_prefill_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                       cache_index, count) -> tuple:
    """Span prefill: project a (B, C, d) chunk, write its K/V IN PLACE at
    per-row cache indices (``count`` masks each row's valid lanes),
    attend causally over the cache.  Returns ``(out, k_cache, v_cache)``.
    RoPE is applied at the absolute positions ``cache_index + lane``."""
    B, C, d = x.shape
    H, KV, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(B, C, H, h)
    k = dense_apply(p["wk"], x).reshape(B, C, KV, h)
    v = dense_apply(p["wv"], x).reshape(B, C, KV, h)
    ci = _per_row(cache_index, B, x.device)
    cnt = torch.as_tensor(count, device=x.device).long()
    if cfg.rope_theta > 0:
        pos = ci[:, None] + torch.arange(C, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_cache = kv_cache_update_span(cache["k"], k, ci, cnt)
    v_cache = kv_cache_update_span(cache["v"], v, ci, cnt)
    out = prefill_attention(q, k_cache, v_cache, ci)
    y = dense_apply(p["wo"], out.reshape(B, C, H * h))
    return y, k_cache, v_cache


def cross_decode_apply(p: dict, cfg, x: torch.Tensor,
                       cross_kv: dict) -> torch.Tensor:
    """One-token cross attention against precomputed K/V ``cross_kv``
    {"k", "v"} (B, T, KV, dh): every one of the T entries is attended."""
    B = x.shape[0]
    H, h = cfg.n_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(B, 1, H, h)
    T = cross_kv["k"].shape[1]
    out = decode_attention(q, cross_kv["k"], cross_kv["v"], T)
    return dense_apply(p["wo"], out.reshape(B, 1, H * h))
