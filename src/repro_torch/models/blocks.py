"""Pre-norm residual blocks for the dense, MoE, SSM and hybrid families.

Port of ``repro/models/blocks.py`` for the ``dense``, ``moe``, ``ssm``
(mamba only, no FFN) and ``hybrid`` (Hymba: attention and mamba heads in
parallel on the same normed input, mean-fused) kinds.  The encdec and vlm
kinds are not ported yet and raise, naming their ROADMAP item.  Caches
are updated IN PLACE.
"""

from __future__ import annotations

import torch

from . import layers as L
from . import moe as M
from . import ssm as S

PORTED_KINDS = ("dense", "moe", "ssm", "hybrid")


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1 "
            f"item 10: encdec/vlm)")


def layer_init(gen: torch.Generator, cfg, dtype, kind: str) -> dict:
    check_kind(kind)
    d, nk = cfg.d_model, cfg.norm
    out = {"ln1": L.norm_init(gen, d, nk, dtype)}
    if kind != "ssm":
        out["attn"] = L.attn_init(gen, cfg, dtype)
    if kind in ("ssm", "hybrid"):
        out["ssm"] = S.ssm_init(gen, cfg, dtype)
        if kind == "ssm":
            return out  # the mamba block has no FFN (falcon-mamba d_ff=0)
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
                causal: bool = True, schedule: str = "masked",
                q_chunk: int = 1024, k_chunk: int = 1024,
                ssm_chunk: int = 256) -> torch.Tensor:
    """One block forward (whole sequence)."""
    check_kind(kind)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        return x + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk)
    a = L.attn_apply(p["attn"], cfg, h, causal=causal, schedule=schedule,
                     q_chunk=q_chunk, k_chunk=k_chunk)
    if kind == "hybrid":
        a = (a + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk)) * 0.5
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind)


def layer_decode_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                       cache_index, kind: str):
    """One block, one token; ``cache`` = this layer's {"k", "v"} and/or
    {"conv", "h"}, updated IN PLACE.  Returns ``(x, cache)``.

    ``cache_index`` is a scalar or a per-row ``(B,)`` vector (each decode
    slot at its own position).  A sliding-window cache is a ring buffer:
    the write index wraps and every entry is valid once it is full."""
    check_kind(kind)
    B = x.shape[0]
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        y, _ = S.ssm_decode_apply(p["ssm"], cfg, h, cache)
        return x + y, cache
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
