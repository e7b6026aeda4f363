"""Pre-norm residual blocks of every family.

Port of ``repro/models/blocks.py``: the ``dense``, ``moe``, ``ssm``
(mamba only, no FFN), ``hybrid`` (Hymba: attention and mamba heads in
parallel on the same normed input, mean-fused), ``enc`` (whisper's
encoder: non-causal self attention), ``dec`` (whisper's decoder: causal
self attention, then cross attention to the encoder output ``ctx``) and
``cross`` (the vision-language model's cross layer: cross attention to
the un-normed vision embeddings ``ctx`` in place of self attention)
kinds.  Caches are updated IN PLACE.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers as L
from . import moe as M
from . import ssm as S

def layer_init(gen: torch.Generator, cfg, dtype, kind: str) -> dict:
    d, nk = cfg.d_model, cfg.norm
    out = {"ln1": L.norm_init(gen, d, nk, dtype)}
    if kind != "ssm":
        out["attn"] = L.attn_init(gen, cfg, dtype)
    if kind in ("ssm", "hybrid"):
        out["ssm"] = S.ssm_init(gen, cfg, dtype)
        if kind == "ssm":
            return out  # the mamba block has no FFN (falcon-mamba d_ff=0)
    if kind == "dec":
        out["lnx"] = L.norm_init(gen, d, nk, dtype)
        out["cross"] = L.attn_init(gen, cfg, dtype)
    out["ln2"] = L.norm_init(gen, d, nk, dtype)
    if kind == "moe":
        out["moe"] = M.moe_init(gen, cfg, dtype)
    else:
        out["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.act, dtype)
    return out


def _ffn(p: dict, cfg, h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "moe":
        return M.moe_apply(p["moe"], cfg, h)
    return L.mlp_apply(p["mlp"], h, cfg.act)


def layer_apply(p: dict, cfg, x: torch.Tensor, kind: str, *,
                ctx: Optional[torch.Tensor] = None,
                causal: bool = True, schedule: str = "masked",
                q_chunk: int = 1024, k_chunk: int = 1024,
                ssm_chunk: int = 256) -> torch.Tensor:
    """One block forward (whole sequence); ``ctx`` (B, T, d) is what the
    ``dec`` and ``cross`` kinds attend to."""
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        return x + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk)
    akw = dict(schedule=schedule, q_chunk=q_chunk, k_chunk=k_chunk)
    if kind == "cross":
        a = L.attn_apply(p["attn"], cfg, h, kv_src=ctx, causal=False, **akw)
    else:
        a = L.attn_apply(p["attn"], cfg, h, causal=causal, **akw)
    if kind == "hybrid":
        a = (a + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk)) * 0.5
    x = x + a
    if kind == "dec":
        h = L.norm_apply(p["lnx"], x, cfg.norm)
        x = x + L.attn_apply(p["cross"], cfg, h, kv_src=ctx, causal=False,
                             **akw)
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind)


def layer_decode_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                       cache_index, kind: str, *,
                       ctx_kv: Optional[dict] = None):
    """One block, one token; ``cache`` = this layer's {"k", "v"} and/or
    {"conv", "h"} ({} for a ``cross`` layer), updated IN PLACE; ``ctx_kv``
    = this layer's precomputed cross K/V {"k", "v"} (B, T, KV, dh) for
    the ``dec`` and ``cross`` kinds.  Returns ``(x, cache)``.

    ``cache_index`` is a scalar or a per-row ``(B,)`` vector (each decode
    slot at its own position).  A sliding-window cache is a ring buffer:
    the write index wraps and every entry is valid once it is full."""
    B = x.shape[0]
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        y, _ = S.ssm_decode_apply(p["ssm"], cfg, h, cache)
        return x + y, cache
    if kind == "cross":
        x = x + L.cross_decode_apply(p["attn"], cfg, h, ctx_kv)
        h = L.norm_apply(p["ln2"], x, cfg.norm)
        return x + _ffn(p, cfg, h, kind), cache
    T = cache["k"].shape[1]
    ci = L._per_row(cache_index, B, x.device)
    idx = torch.remainder(ci, T) if cfg.sliding_window > 0 else ci
    pa = p["attn"]
    q = L.dense_apply(pa["wq"], h).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k = L.dense_apply(pa["wk"], h).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense_apply(pa["wv"], h).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        pos = ci[:, None]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    kc = L.kv_cache_update(cache["k"], k, idx)
    vc = L.kv_cache_update(cache["v"], v, idx)
    valid = torch.clamp(ci + 1, max=T)
    a = L.dense_apply(pa["wo"],
                      L.decode_attention(q, kc, vc, valid).reshape(B, 1, -1))
    if kind == "hybrid":
        y, _ = S.ssm_decode_apply(p["ssm"], cfg, h, cache)
        a = (a + y) * 0.5
    x = x + a
    if kind == "dec":
        h = L.norm_apply(p["lnx"], x, cfg.norm)
        x = x + L.cross_decode_apply(p["cross"], cfg, h, ctx_kv)
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind), cache


def layer_prefill_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                        cache_index, count, kind: str):
    """One block over a ``(B, C)`` token span (chunked prefill); the
    layer's cache is updated IN PLACE.  Returns ``(x, cache)``."""
    if kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"span prefill is only defined for dense/moe blocks, "
            f"not kind={kind!r}")
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    a, _, _ = L.attn_prefill_apply(p["attn"], cfg, h, cache, cache_index,
                                   count)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind), cache
