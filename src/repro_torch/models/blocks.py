"""Pre-norm residual blocks of every family.

Port of ``repro/models/blocks.py``: the ``dense``, ``moe``, ``ssm``
(mamba only, no FFN), ``hybrid`` (Hymba: attention and mamba heads in
parallel on the same normed input, mean-fused), ``enc`` (whisper's
encoder: non-causal self attention), ``dec`` (whisper's decoder: causal
self attention, then cross attention to the encoder output ``ctx``) and
``cross`` (the vision-language model's cross layer: cross attention to
the un-normed vision embeddings ``ctx`` in place of self attention)
kinds.  Caches are updated IN PLACE.

With sequence parallelism (``sp``: a model axis whose size divides the
sequence, ``distributed.sharding.seq_sharded``) ``x`` is this model
rank's block of rows: each norm runs on the block, its output is
all-gathered once (``comm.gather_from_sp``) and read by every sublayer
that takes it — in the ``hybrid`` kind attention and the mamba heads
alike — and each sublayer's output comes back as this rank's block.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.comm import copy_to_tp, gather_from_sp, reduce_from_tp
from . import layers as L
from . import moe as M
from . import ssm as S

def layer_shapes(cfg, dtype, kind: str) -> dict:
    return layer_init(L._MetaGenerator(), cfg, dtype, kind)


def layer_cache_shapes(cfg, kind: str, B: int, cache_len: int,
                       dtype) -> dict:
    """One layer's decode cache as meta tensors: ``{"k", "v"}`` (B, T, KV,
    dh) for self attention (a sliding-window config keeps only the
    window, a ring buffer), the mamba heads' ``{"conv", "h"}``, nothing
    for a ``cross`` layer (its K/V are ``cross_kv``)."""
    out = {}
    if kind in ("dense", "moe", "hybrid", "dec"):
        T = min(cache_len, cfg.sliding_window) \
            if cfg.sliding_window > 0 else cache_len
        shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = torch.empty(shape, dtype=dtype, device="meta")
        out["v"] = torch.empty(shape, dtype=dtype, device="meta")
    if kind in ("ssm", "hybrid"):
        out.update(S.ssm_cache_shapes(cfg, B, dtype))
    return out


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


def _ffn(p: dict, cfg, h: torch.Tensor, kind: str, tp=None,
         ep=None, sp: bool = False, dp=None) -> torch.Tensor:
    if kind == "moe":
        return M.moe_apply(p["moe"], cfg, h, tp=tp, ep=ep, sp=sp, dp=dp)
    return L.mlp_apply(p["mlp"], h, cfg.act, tp, sp)


def _norm(p: dict, x: torch.Tensor, cfg, tp, sp: bool) -> torch.Tensor:
    """The pre-norm of a sublayer: with ``sp`` on this rank's rows, then
    all-gathered into the whole sequence the sublayer reads."""
    h = L.norm_apply(p, x, cfg.norm)
    return gather_from_sp(h, tp) if sp else h


def layer_apply(p: dict, cfg, x: torch.Tensor, kind: str, *,
                ctx: Optional[torch.Tensor] = None,
                causal: bool = True, schedule: str = "masked",
                q_chunk: int = 1024, k_chunk: int = 1024,
                ssm_chunk: int = 256, tp=None, ep=None, sp: bool = False,
                ctx_sp: bool = False, dp=None) -> torch.Tensor:
    """One block forward (whole sequence); ``ctx`` (B, T, d) is what the
    ``dec`` and ``cross`` kinds attend to.  ``tp``: a model-axis
    ``Collectives`` when ``p`` is one model rank's compute shards; ``ep``:
    an expert-axis one when the MoE layer takes the EP round; ``dp``: a
    data-axis one, over which the MoE layer sizes capacity and slot
    positions (``moe.moe_apply``).  ``sp``: ``x`` is this model rank's
    block of the sequence (the result is too); ``ctx_sp``: ``ctx`` is this
    rank's block of the context."""
    h = _norm(p["ln1"], x, cfg, tp, sp)
    if kind == "ssm":
        return x + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk, tp=tp,
                               sp=sp)
    akw = dict(schedule=schedule, q_chunk=q_chunk, k_chunk=k_chunk, tp=tp,
               sp=sp)
    if kind == "cross":
        a = L.attn_apply(p["attn"], cfg, h, kv_src=ctx, kv_sp=ctx_sp,
                         causal=False, **akw)
    else:
        a = L.attn_apply(p["attn"], cfg, h, causal=causal, **akw)
    if kind == "hybrid":
        # the same gathered h feeds the mamba heads
        a = (a + S.ssm_apply(p["ssm"], cfg, h, chunk=ssm_chunk, tp=tp,
                             sp=sp)) * 0.5
    x = x + a
    if kind == "dec":
        h = _norm(p["lnx"], x, cfg, tp, sp)
        x = x + L.attn_apply(p["cross"], cfg, h, kv_src=ctx, kv_sp=ctx_sp,
                             causal=False, **akw)
    h = _norm(p["ln2"], x, cfg, tp, sp)
    return x + _ffn(p, cfg, h, kind, tp, ep, sp, dp)


def layer_decode_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                       cache_index, kind: str, *,
                       ctx_kv: Optional[dict] = None, tp=None, ep=None,
                       dp=None, cp=None):
    """One block, one token; ``cache`` = this layer's {"k", "v"} and/or
    {"conv", "h"} ({} for a ``cross`` layer), updated IN PLACE; ``ctx_kv``
    = this layer's precomputed cross K/V {"k", "v"} (B, T, KV, dh) for
    the ``dec`` and ``cross`` kinds.  Returns ``(x, cache)``.

    ``cache_index`` is a scalar or a per-row ``(B,)`` vector (each decode
    slot at its own position).  A sliding-window cache is a ring buffer:
    the write index wraps and every entry is valid once it is full.
    ``tp``: a model-axis ``Collectives`` when ``p`` and the caches are one
    model rank's (q/k/v column-parallel on its heads, ``wo``, the FFN and
    the mamba ``out_proj`` row-parallel); ``ep``: an expert-axis one when
    the MoE layer takes the EP round (inside the tensor-parallel region
    when both are given); ``dp`` as in :func:`layer_apply`.

    ``cp``: the self-attention cache is this rank's block of ``T`` over
    ``cp``'s ranks (context parallelism, ``models.model.init_cache(...,
    context=True)``).  The new token's K/V land only in the block that
    holds its position (clamped to ``T - 1``, or modulo ``T`` in a ring),
    and attention combines the blocks' partial softmax sums
    (:func:`~repro_torch.models.layers.decode_attention_cp`).  Where the
    time axis is over ``"model"`` (``"model"`` in ``cp.axes``) and the
    heads split over the model ranks, each rank's query, key and value
    heads are all-gathered over them first (one all-gather on ``tp``;
    where ``KV < m`` one copy of each KV head is kept), every rank attends
    with every head over its block, and keeps its own heads for ``wo``."""
    B = x.shape[0]
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if kind == "ssm":
        y, _ = S.ssm_decode_apply(p["ssm"], cfg, h, cache, tp)
        return x + y, cache
    if kind == "cross":
        x = x + L.cross_decode_apply(p["attn"], cfg, h, ctx_kv, tp)
        h = L.norm_apply(p["ln2"], x, cfg.norm)
        return x + _ffn(p, cfg, h, kind, tp, ep, dp=dp), cache
    T = cache["k"].shape[1] * (cp.size if cp is not None else 1)
    ci = L._per_row(cache_index, B, x.device)
    idx = torch.remainder(ci, T) if cfg.sliding_window > 0 else ci
    pa = p["attn"]
    atp, wk, wv = L.tp_heads(pa, cfg, tp)
    ha = copy_to_tp(h, atp)
    q = L.dense_apply(pa["wq"], ha).reshape(B, 1, -1, cfg.head_dim)
    k = L.dense_apply(wk, ha).reshape(B, 1, -1, cfg.head_dim)
    v = L.dense_apply(wv, ha).reshape(B, 1, -1, cfg.head_dim)
    if cfg.rope_theta > 0:
        pos = ci[:, None]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    valid = torch.clamp(ci + 1, max=T)
    if cp is None:
        kc = L.kv_cache_update(cache["k"], k, idx)
        vc = L.kv_cache_update(cache["v"], v, idx)
        o = L.decode_attention(q, kc, vc, valid)
    else:
        heads = atp is not None and "model" in cp.axes
        if heads:
            q, k, v = _all_heads(q, k, v, cfg, atp)
        lo = cp.rank * cache["k"].shape[1]
        idx = torch.clamp(idx, max=T - 1)
        kc = L.kv_cache_update_block(cache["k"], k, idx, lo)
        vc = L.kv_cache_update_block(cache["v"], v, idx, lo)
        o = L.decode_attention_cp(q, kc, vc, valid, cp)
        if heads:
            n = o.shape[2] // atp.size
            o = o[:, :, atp.rank * n:(atp.rank + 1) * n]
    a = reduce_from_tp(L.dense_apply(pa["wo"], o.reshape(B, 1, -1)), atp)
    if kind == "hybrid":
        y, _ = S.ssm_decode_apply(p["ssm"], cfg, h, cache, tp)
        a = (a + y) * 0.5
    x = x + a
    if kind == "dec":
        h = L.norm_apply(p["lnx"], x, cfg.norm)
        x = x + L.cross_decode_apply(p["cross"], cfg, h, ctx_kv, tp)
    h = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, kind, tp, ep, dp=dp), cache


def _all_heads(q, k, v, cfg, tp) -> tuple:
    """Every model rank's query heads and new K/V heads of one decode
    token ``(B, 1, heads, dh)``, all-gathered over ``tp`` in one call (the
    heads in rank order); where ``KV < m`` each KV head is held by ``m /
    KV`` ranks alike, and one copy of each is kept."""
    B, _, Hl, dh = q.shape
    KVl = k.shape[2]
    m = tp.size
    got = tp.all_gather(torch.cat([q.reshape(B, -1), k.reshape(B, -1),
                                   v.reshape(B, -1)], -1)[None])
    got = got.reshape(m, B, Hl + 2 * KVl, dh).transpose(0, 1)
    q, k, v = got.split((Hl, KVl, KVl), dim=2)
    if cfg.n_kv_heads < m:
        k, v = k[:, ::m // cfg.n_kv_heads], v[:, ::m // cfg.n_kv_heads]
    return tuple(t.reshape(B, 1, -1, dh) for t in (q, k, v))


def layer_prefill_apply(p: dict, cfg, x: torch.Tensor, cache: dict,
                        cache_index, count, kind: str, tp=None, ep=None,
                        sp: bool = False, dp=None):
    """One block over a ``(B, C)`` token span (chunked prefill); the
    layer's cache is updated IN PLACE.  Returns ``(x, cache)``.  ``tp``
    and ``ep`` as in :func:`layer_decode_apply`; ``sp`` and ``dp`` as in
    :func:`layer_apply` (the K/V written to the cache are the whole
    chunk's)."""
    if kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"span prefill is only defined for dense/moe blocks, "
            f"not kind={kind!r}")
    h = _norm(p["ln1"], x, cfg, tp, sp)
    a, _, _ = L.attn_prefill_apply(p["attn"], cfg, h, cache, cache_index,
                                   count, tp, sp)
    x = x + a
    h = _norm(p["ln2"], x, cfg, tp, sp)
    return x + _ffn(p, cfg, h, kind, tp, ep, sp, dp), cache
