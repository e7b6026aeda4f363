"""Pre-norm residual transformer blocks for the dense and MoE families.

Port of ``repro/models/blocks.py`` for the ``dense`` and ``moe`` kinds.
The other kinds (ssm, hybrid, encdec, vlm) are not ported yet and raise,
naming their ROADMAP item.  Caches are updated IN PLACE.
"""

from __future__ import annotations

import torch

from . import layers as L
from . import moe as M

PORTED_KINDS = ("dense", "moe")


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1 "
            f"items 9-10: ssm/hybrid, encdec/vlm)")


def layer_init(gen: torch.Generator, cfg, dtype, kind: str) -> dict:
    check_kind(kind)
    d, nk = cfg.d_model, cfg.norm
    out = {"ln1": L.norm_init(gen, d, nk, dtype),
           "attn": L.attn_init(gen, cfg, dtype),
           "ln2": L.norm_init(gen, d, nk, dtype)}
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
                q_chunk: int = 1024, k_chunk: int = 1024) -> torch.Tensor:
    """One block forward (whole sequence)."""
    check_kind(kind)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    x = x + L.attn_apply(p["attn"], cfg, h, causal=causal,
                         schedule=schedule, q_chunk=q_chunk, k_chunk=k_chunk)
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind)


def layer_decode_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                       cache_index, kind: str):
    """One block, one token; ``cache`` = {"k", "v"} of this layer,
    updated IN PLACE.  Returns ``(x, cache)``.

    ``cache_index`` is a scalar or a per-row ``(B,)`` vector (each decode
    slot at its own position).  A sliding-window cache is a ring buffer:
    the write index wraps and every entry is valid once it is full."""
    check_kind(kind)
    B = x.shape[0]
    h = L.norm_apply(p["ln1"], x, cfg.norm)
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
    a = L.decode_attention(q, kc, vc, valid)
    x = x + L.dense_apply(pa["wo"], a.reshape(B, 1, -1))
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind), cache


def layer_prefill_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                        cache_index, count, kind: str):
    """One block over a ``(B, C)`` token span (chunked prefill); the
    layer's cache is updated IN PLACE.  Returns ``(x, cache)``."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"span prefill is only defined for dense/moe blocks, "
            f"not kind={kind!r}")
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    a, _, _ = L.attn_prefill_apply(p["attn"], cfg, h, cache, cache_index,
                                   count)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind), cache
