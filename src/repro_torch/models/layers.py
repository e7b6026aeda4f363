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
* sharding constraints are gone; on a ``"model"`` mesh axis
  :func:`attn_apply`, :func:`attn_prefill_apply`,
  :func:`cross_decode_apply` and :func:`mlp_apply` take one model rank's
  compute shards (``distributed.sharding.tp_local_params``) and a ``tp``
  :class:`~repro_torch.distributed.comm.Collectives`, and run Megatron's
  column-parallel / row-parallel split.  With ``sp`` (sequence
  parallelism) their input is the whole sequence that the caller
  all-gathered from the model ranks' blocks and their output leaves by a
  reduce-scatter onto this rank's block; without it the input is whole
  on every rank and the output is all-reduced (and the input's gradient
  in the backward).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.comm import (
    copy_to_tp, enter_tp, gather_from_sp, leave_tp, reduce_from_tp,
    share_kv,
)
from ..distributed.sharding import attn_split
from ..kernels.flash_attention.ops import flash_attention_op

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Param init (torch-native; same distributions as the reference)
# ---------------------------------------------------------------------------


class _MetaGenerator:
    """Stands in for a generator where only shapes and dtypes are wanted:
    every ``*_init`` given one builds its tree of meta tensors, which is
    that init's ``*_shapes`` twin (the reference's ``ShapeDtypeStruct``
    trees)."""

    device = torch.device("meta")


def _norm_init(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    if gen.device.type == "meta":  # shapes only (the *_shapes twins)
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, bias: bool, dtype) -> dict:
    out = {"w": _norm_init(gen, (d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        out["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return out


def dense_shapes(d_in: int, d_out: int, bias: bool, dtype) -> dict:
    return dense_init(_MetaGenerator(), d_in, d_out, bias, dtype)


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


def norm_shapes(d: int, kind: str, dtype) -> dict:
    return norm_init(_MetaGenerator(), d, kind, dtype)


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


def mlp_shapes(d: int, f: int, act: str, dtype) -> dict:
    return mlp_init(_MetaGenerator(), d, f, act, dtype)


def mlp_apply(p: dict, x: torch.Tensor, act: str, tp=None,
              sp: bool = False) -> torch.Tensor:
    """The MLP; with ``tp`` (a model-axis ``Collectives``) ``p`` holds this
    rank's columns of ``w1``/``w3``/``b1`` and rows of ``w2``, whose
    partial products are all-reduced (with ``sp``, ``x`` gathered from the
    sequence blocks: reduce-scattered onto this rank's block) before
    ``b2`` is added."""
    x = enter_tp(x, tp, gathered=sp)
    if act == "swiglu":
        return leave_tp((F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"],
                        tp, sp=sp)
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return leave_tp(h @ p["w2"], tp, sp=sp) + p["b2"]


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


def decode_attention_cp(
    q: torch.Tensor,        # (B, 1, H, dh): every query head
    k_block: torch.Tensor,  # (B, T/c, KV, dh): this rank's block of T
    v_block: torch.Tensor,
    valid: torch.Tensor,    # (B,) valid entries of the whole cache
    cp,
) -> torch.Tensor:
    """:func:`decode_attention` with the cache's time axis over the ``c``
    ranks of ``cp`` (context parallelism): this rank holds positions
    ``[r·T/c, (r+1)·T/c)``.  The scores' maximum is all-reduced (``op=
    "max"``) first; each rank's ``exp(s - max)`` sums and its weighted sum
    of values are then all-reduced as one tensor and divided: the online
    softmax's combine, two all-reduces.  A block with no valid position
    (masked to ``NEG_INF``) adds ``exp(NEG_INF - max) = 0``: position 0 is
    always valid, so the maximum is finite and no NaN arises."""
    B, _, H, dh = q.shape
    Tl, KV = k_block.shape[1], k_block.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_block.float()) \
        * dh ** -0.5
    pos = cp.rank * Tl + torch.arange(Tl, device=q.device)
    mask = pos[None, :] < valid[:, None]                    # (B, T/c)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    mx = cp.all_reduce(s.amax(dim=-1), op="max")            # (B, KV, G)
    p = torch.exp(s - mx[..., None])
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_block.dtype).float(),
                       v_block.float())
    both = cp.all_reduce(torch.cat([out, p.sum(dim=-1)[..., None]], -1))
    out = both[..., :dh] / both[..., dh:]
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


def attn_shapes(cfg, dtype, cross: bool = False) -> dict:
    """``cross`` is accepted for the reference's signature: cross
    attention has the same projections."""
    return attn_init(_MetaGenerator(), cfg, dtype)


def tp_heads(p: dict, cfg, tp) -> tuple:
    """``(tp, wk, wv)`` for an attention layer on the model ranks of
    ``tp``: ``tp`` itself where the heads split over it
    (:func:`~repro_torch.distributed.sharding.attn_split`), else None (the
    layer runs whole on every rank); ``p``'s K/V weights, which where
    ``KV < m`` several ranks hold alike (their gradient summed over
    those ranks)."""
    if tp is not None and not attn_split(cfg, tp.size):
        tp = None
    wk, wv = p["wk"], p["wv"]
    if tp is not None and cfg.n_kv_heads % tp.size:
        head = tp.rank // (tp.size // cfg.n_kv_heads)
        wk, wv = ({k: share_kv(t, tp, head, cfg.n_kv_heads)
                   for k, t in w.items()} for w in (wk, wv))
    return tp, wk, wv


def attn_apply(
    p: dict, cfg, x: torch.Tensor, *,
    kv_src: Optional[torch.Tensor] = None,
    kv_sp: bool = False,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    schedule: str = "masked",
    q_chunk: int = 1024, k_chunk: int = 1024,
    tp=None, sp: bool = False,
) -> torch.Tensor:
    """Whole-sequence attention through the flash-attention kernel: self
    attention, or cross attention to ``kv_src`` (B, T, d), which gives K
    and V, takes no RoPE and no window and is never causal.

    With ``tp`` (a model-axis ``Collectives``) and heads that split over
    it (:func:`~repro_torch.distributed.sharding.attn_split`), ``p`` holds
    this rank's ``H/m`` query heads and their KV heads (``wq|wk|wv``
    column-parallel, ``wo`` row-parallel): the kernel runs on the local
    heads and ``wo``'s partial product is all-reduced.  Where ``KV < m``
    several ranks hold one KV head and its gradient is summed over them.
    Where the heads do not split (hymba-1.5b's 25 over 2), ``p`` is whole
    (the compute layout replicates it, the storage specs' column shards
    gathered) and the layer runs whole on every rank with no collective.

    With ``sp`` ``x`` is the whole sequence that the caller all-gathered
    from the model ranks' blocks, and the output is this rank's block:
    ``wo``'s partial product reduce-scattered, or where the layer runs
    whole its result sliced (its gradient all-gathered, and only this
    rank's block of its input's gradient passed back, so that the
    gather's reduce-scatter does not sum ``m`` equal copies).  ``kv_sp``:
    ``kv_src`` is this rank's block of the context, gathered here.

    ``schedule``, ``q_chunk`` and ``k_chunk`` are kept for signature
    parity with the reference and ignored: the kernel bounds each query
    tile's key loop to the blocks that meet the causal triangle or the
    window band, which is the reference's "tri"/"window" schedule."""
    B, S, d = x.shape
    h = cfg.head_dim
    atp, wk, wv = tp_heads(p, cfg, tp)
    split = atp is not None
    x = enter_tp(x, tp, split=split, gathered=sp)
    src = x
    if kv_src is not None:
        if kv_sp:
            kv_src = gather_from_sp(kv_src, tp)
        src = enter_tp(kv_src, tp, split=split, gathered=kv_sp)
    T = src.shape[1]
    q = dense_apply(p["wq"], x).reshape(B, S, -1, h)
    k = dense_apply(wk, src).reshape(B, T, -1, h)
    v = dense_apply(wv, src).reshape(B, T, -1, h)
    if kv_src is None and cfg.rope_theta > 0:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention_op(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal and kv_src is None,
        window=cfg.sliding_window if kv_src is None else 0)
    return leave_tp(dense_apply(p["wo"], out.reshape(B, S, -1)), tp,
                    split=split, sp=sp)


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


def kv_cache_update_block(cache_arr: torch.Tensor, new: torch.Tensor,
                          idx: torch.Tensor, lo: int) -> torch.Tensor:
    """Write a one-token K/V slice ``new`` (B, 1, KV, h) IN PLACE into a
    rank's block ``cache_arr`` (B, T/c, KV, h) of a cache whose time axis
    is split over ranks, at per-row global positions ``idx`` (B,): a row
    whose position lies in ``[lo, lo + T/c)`` writes there, every other
    row leaves the block as it is (a masked write: no rank writes into
    its own block what another rank owns).  Returns ``cache_arr``."""
    B, Tl = cache_arr.shape[0], cache_arr.shape[1]
    local = idx.long() - lo
    mine = (local >= 0) & (local < Tl)
    rows = torch.arange(B, device=cache_arr.device)
    at = torch.clamp(local, 0, Tl - 1)
    cache_arr[rows, at] = torch.where(mine[:, None, None],
                                      new[:, 0].to(cache_arr.dtype),
                                      cache_arr[rows, at])
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
                       cache_index, count, tp=None, sp: bool = False
                       ) -> tuple:
    """Span prefill: project a (B, C, d) chunk, write its K/V IN PLACE at
    per-row cache indices (``count`` masks each row's valid lanes),
    attend causally over the cache.  Returns ``(out, k_cache, v_cache)``.
    RoPE is applied at the absolute positions ``cache_index + lane``.
    With ``tp`` and ``sp`` as in :func:`attn_apply`: the rank's heads, its
    cache of their K/V (written from the whole chunk), ``wo``'s partial
    product all-reduced or, with ``sp``, reduce-scattered."""
    B, C, d = x.shape
    h = cfg.head_dim
    atp, wk, wv = tp_heads(p, cfg, tp)
    split = atp is not None
    x = enter_tp(x, tp, split=split, gathered=sp)
    q = dense_apply(p["wq"], x).reshape(B, C, -1, h)
    k = dense_apply(wk, x).reshape(B, C, -1, h)
    v = dense_apply(wv, x).reshape(B, C, -1, h)
    ci = _per_row(cache_index, B, x.device)
    cnt = torch.as_tensor(count, device=x.device).long()
    if cfg.rope_theta > 0:
        pos = ci[:, None] + torch.arange(C, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_cache = kv_cache_update_span(cache["k"], k, ci, cnt)
    v_cache = kv_cache_update_span(cache["v"], v, ci, cnt)
    out = prefill_attention(q, k_cache, v_cache, ci)
    y = leave_tp(dense_apply(p["wo"], out.reshape(B, C, -1)), tp,
                 split=split, sp=sp)
    return y, k_cache, v_cache


def cross_decode_apply(p: dict, cfg, x: torch.Tensor,
                       cross_kv: dict, tp=None) -> torch.Tensor:
    """One-token cross attention against precomputed K/V ``cross_kv``
    {"k", "v"} (B, T, KV, dh): every one of the T entries is attended.
    With ``tp`` as in :func:`attn_apply` (``cross_kv`` holds the rank's
    KV heads)."""
    B = x.shape[0]
    tp, _, _ = tp_heads(p, cfg, tp)
    q = dense_apply(p["wq"], copy_to_tp(x, tp)).reshape(B, 1, -1,
                                                        cfg.head_dim)
    T = cross_kv["k"].shape[1]
    out = decode_attention(q, cross_kv["k"], cross_kv["v"], T)
    return reduce_from_tp(dense_apply(p["wo"], out.reshape(B, 1, -1)), tp)
