"""Model: init / forward / loss / prefill / decode for every family.

Port of ``repro/models/model.py``.  Parameters are nested dicts of
tensors in the reference's layout, so weights bridged from the reference
drop straight in: one stack ``params["layers"]`` whose leaves carry a
leading ``(L,)`` layer dim for the dense, MoE, SSM and hybrid families;
``enc_layers`` and ``dec_layers`` (and ``enc_norm``) for encdec
(whisper); ``self_layers`` with a leading ``(g, k-1)`` and
``cross_layers`` with ``(g,)`` for vlm, g groups of k-1 self layers and
one cross layer.  The layer scans become Python loops over those dims.
Caches mirror the stacks (``{"k", "v"}`` of shape ``(L, B, T, KV, dh)``
for attention, ``{"conv", "h"}`` for the mamba heads, none for the
encoder or the vlm cross layers) plus ``cross_kv``, the cross layers'
precomputed K/V, and :func:`decode_step` / :func:`prefill_step` update
them IN PLACE (each layer writes through a view of its slice).
"""

from __future__ import annotations

import itertools
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device, torch_dtype
from ..distributed.sharding import shard_act, shard_logits
from . import blocks as B
from . import layers as L


def _plan(cfg: ModelConfig):
    """Stack plan: list of (name, kind, n_layers, nested_inner)."""
    if cfg.family == "dense":
        return [("layers", "dense", cfg.n_layers, 0)]
    if cfg.family == "moe":
        return [("layers", "moe", cfg.n_layers, 0)]
    if cfg.family == "ssm":
        return [("layers", "ssm", cfg.n_layers, 0)]
    if cfg.family == "hybrid":
        return [("layers", "hybrid", cfg.n_layers, 0)]
    if cfg.family == "encdec":
        return [("enc_layers", "enc", cfg.enc_layers, 0),
                ("dec_layers", "dec", cfg.n_layers, 0)]
    if cfg.family == "vlm":
        k = cfg.cross_every
        if cfg.n_layers % k:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple "
                             f"of cross_every {k}")
        g = cfg.n_layers // k
        return [("self_layers", "dense", g, k - 1),  # (g, k-1, ...)
                ("cross_layers", "cross", g, 0)]
    raise ValueError(cfg.family)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, so writes land in place)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: dict) -> list:
    """The layers of a stacked tree, as per-layer trees of views
    (``torch.unbind``).  Under autograd each leaf's gradient is then
    stacked once; taking the layers one index at a time would build a
    full-stack gradient per layer and add them up (L full-stack adds,
    ~0.15 s of a full-width granite training step)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _stacked_init(make, lead: tuple) -> dict:
    """Stack trees from ``make()`` along new leading dims ``lead`` (the
    layer count, or the vlm's ``(g, k-1)``), filling preallocated stacks
    one layer at a time (peak memory: the stack plus one layer, which
    lets falcon-mamba-7b in fp32 fit on one card)."""
    first = make()

    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty(lead + tuple(t.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)
    out = alloc(first)
    fill(out, first, (0,) * len(lead))
    del first
    for i in list(itertools.product(*map(range, lead)))[1:]:
        fill(out, make(), i)
    return out


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random weights with the reference's distributions (normal embed
    ×0.02, lm_head ×d^-0.5, weights ×fan_in^-0.5, unit norm scales, fp32
    router, fp32 ``A_log = log(1..N)`` and ``D = 1``), drawn from
    ``generator`` on ``device`` (``None`` = the card; a fresh generator
    seeded 0 when none is given).  Used where the
    reference cannot run, e.g. full-width weights on the card; parity
    tests bridge the reference's own weights instead."""
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    return _init(cfg, gen)


class _MetaGenerator:
    """Stands in for a generator where only shapes and dtypes are wanted."""

    device = torch.device("meta")


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors — shapes and dtypes, no storage:
    the counterpart of the reference's ``ShapeDtypeStruct`` tree (the
    train step counts its leaves for the gradient-bucket plan)."""
    return _init(cfg, _MetaGenerator())


def _init(cfg: ModelConfig, gen) -> dict:
    dt = torch_dtype(cfg.dtype)
    out = {
        "embed": L._norm_init(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": L.norm_init(gen, cfg.d_model, cfg.norm, dt),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = L._norm_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dt)
    for name, kind, n, inner in _plan(cfg):
        out[name] = _stacked_init(lambda: B.layer_init(gen, cfg, dt, kind),
                                  (n, inner) if inner else (n,))
    if cfg.family == "encdec":
        out["enc_norm"] = L.norm_init(gen, cfg.d_model, cfg.norm, dt)
    return out


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _n_layers(stack: dict) -> int:
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# Forward (whole sequence)
# ---------------------------------------------------------------------------


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            schedule: str = "masked", q_chunk: int = 1024,
            k_chunk: int = 1024, ssm_chunk: int = 256, remat: bool = True,
            last_only: bool = False) -> torch.Tensor:
    """Logits for (B, S) tokens; encdec also reads ``batch["enc_frames"]``
    (B, enc_seq, d), run through the non-causal encoder into the
    decoder's cross attention, and vlm ``batch["vis_embed"]`` (B, vis_seq,
    d), which every cross layer attends to.  On CUDA tensors self, encoder
    and cross attention run the flash-attention kernel (a vlm group's k-1
    self layers are unbound one stack level at a time, so that autograd
    still stacks each leaf's gradient once) and every mamba head the
    selective-scan kernel, one launch per ``ssm_chunk`` tokens (S must be
    a multiple of it when larger).  ``last_only`` slices to the final
    position before the lm_head matmul.  Differentiable on both devices:
    on CUDA tensors that require grad the kernels run under their
    ``torch.autograd.Function``s, whose backward launches the hand-written
    backward kernels (``flash_attention``, ``moe_gmm``, ``ssm_scan``).
    ``schedule``/``q_chunk``/``k_chunk`` are accepted for signature parity
    and have no effect (the kernels bound their loops themselves).

    ``remat`` (the default, as in the reference's ``jax.checkpoint(...,
    nothing_saveable)`` over the layer scan): when grad is enabled, each
    layer runs under non-reentrant ``torch.utils.checkpoint``, which keeps
    only the layer's inputs and runs the layer again in the backward (so
    every kernel a layer launches launches twice per training
    microbatch).  Without grad nothing is wrapped."""
    x = shard_act(params["embed"][batch["tokens"].long()])
    kw = dict(schedule=schedule, q_chunk=q_chunk, k_chunk=k_chunk,
              ssm_chunk=ssm_chunk)
    layer = B.layer_apply
    if remat and torch.is_grad_enabled():
        def layer(*a, **k):
            return checkpoint(B.layer_apply, *a, use_reentrant=False, **k)
    if cfg.family == "encdec":
        enc = shard_act(batch["enc_frames"].to(x.dtype))
        for p in _unbind(params["enc_layers"]):
            enc = layer(p, cfg, enc, "enc", causal=False, **kw)
        ctx = L.norm_apply(params["enc_norm"], enc, cfg.norm)
        for p in _unbind(params["dec_layers"]):
            x = layer(p, cfg, x, "dec", ctx=ctx, **kw)
    elif cfg.family == "vlm":
        ctx = shard_act(batch["vis_embed"].to(x.dtype))
        for gself, gcross in zip(_unbind(params["self_layers"]),
                                 _unbind(params["cross_layers"])):
            for p in _unbind(gself):
                x = layer(p, cfg, x, "dense", **kw)
            x = layer(gcross, cfg, x, "cross", ctx=ctx, **kw)
    else:
        kind = _plan(cfg)[0][1]
        for p in _unbind(params["layers"]):
            x = layer(p, cfg, x, kind, **kw)
    if last_only:
        x = x[:, -1:]
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return shard_logits(x @ _head(params, cfg))


def loss_fn(params, cfg, batch, **kw):
    """Mean next-token cross entropy; vocab-padding logits are masked out
    of the partition function."""
    logits = forward(params, cfg, batch, **kw).float()
    labels = batch["labels"]
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, bsz: int, cache_len: int,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """Zero caches on ``device`` (``None`` = the card), the reference's
    tree: per stack, leaves with its leading layer dims — KV ``{"k",
    "v"}`` of shape ``(L, bsz, T, KV, dh)`` for self attention (a
    sliding-window config keeps only the window, a ring buffer; vlm's
    ``self_layers`` lead with ``(g, k-1)``) and ``{"conv" (L, bsz, cw-1,
    Di), "h" (L, bsz, Di, N) fp32}`` for the mamba heads; no entry for
    the encoder stack and ``{}`` for vlm's cross layers.  encdec and vlm
    add ``cross_kv`` {"k", "v"}, the cross layers' K/V over the encoder
    output or the vision embeddings, ``(n_layers, bsz, enc_seq, KV, dh)``
    or ``(g, bsz, vis_seq, KV, dh)``, zero-filled: the caller fills it."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    out = {}
    for name, kind, n, inner in _plan(cfg):
        if kind == "enc":
            continue
        lead = (n, inner) if inner else (n,)
        layer = {}
        if kind not in ("ssm", "cross"):
            T = min(cache_len, cfg.sliding_window) \
                if cfg.sliding_window > 0 else cache_len
            shape = lead + (bsz, T, cfg.n_kv_heads, cfg.head_dim)
            layer["k"] = torch.zeros(shape, dtype=dt, device=dev)
            layer["v"] = torch.zeros(shape, dtype=dt, device=dev)
        if kind in ("ssm", "hybrid"):
            di = cfg.d_inner
            layer["conv"] = torch.zeros(lead + (bsz, cfg.conv_width - 1, di),
                                        dtype=dt, device=dev)
            layer["h"] = torch.zeros(lead + (bsz, di, cfg.ssm_state),
                                     dtype=torch.float32, device=dev)
        out[name] = layer
    if cfg.family in ("encdec", "vlm"):
        n, T = (cfg.n_layers, cfg.enc_seq) if cfg.family == "encdec" \
            else (cfg.n_layers // cfg.cross_every, cfg.vis_seq)
        shape = (n, bsz, T, cfg.n_kv_heads, cfg.head_dim)
        out["cross_kv"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)}
    return out


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                batch: dict) -> tuple:
    """One token for every sequence against the cache.

    batch = {"tokens": (B, 1), "cache_index": () or (B,)} — returns
    (logits (B, padded_vocab), cache), the cache updated IN PLACE.
    encdec and vlm read the cross layers' K/V from ``cache["cross_kv"]``
    (decoder layer ``i`` or group ``gi``)."""
    ci = batch["cache_index"]
    x = shard_act(params["embed"][batch["tokens"].long()])
    if cfg.family == "vlm":
        selfp, selfc = params["self_layers"], cache["self_layers"]
        for gi in range(_n_layers(params["cross_layers"])):
            gp, gc = _layer(selfp, gi), _layer(selfc, gi)
            for j in range(_n_layers(gp)):
                x, _ = B.layer_decode_apply(_layer(gp, j), cfg, x,
                                            _layer(gc, j), ci, "dense")
            x, _ = B.layer_decode_apply(
                _layer(params["cross_layers"], gi), cfg, x, {}, ci, "cross",
                ctx_kv=_layer(cache["cross_kv"], gi))
    elif cfg.family == "encdec":
        stack = params["dec_layers"]
        for i in range(_n_layers(stack)):
            x, _ = B.layer_decode_apply(
                _layer(stack, i), cfg, x, _layer(cache["dec_layers"], i), ci,
                "dec", ctx_kv=_layer(cache["cross_kv"], i))
    else:
        kind = _plan(cfg)[0][1]
        stack = params["layers"]
        for i in range(_n_layers(stack)):
            x, _ = B.layer_decode_apply(_layer(stack, i), cfg, x,
                                        _layer(cache["layers"], i), ci, kind)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return shard_logits((x @ _head(params, cfg))[:, 0]), cache


def prefill_step(params: dict, cfg: ModelConfig, cache: dict,
                 batch: dict) -> tuple:
    """Write a span of prompt tokens through the model at per-row cache
    indices — the chunked-prefill primitive of the continuous batcher.

    batch = {"tokens": (B, C), "cache_index": (B,), "count": (B,)}: row
    b's ``tokens[b, :count[b]]`` land at cache positions
    ``cache_index[b] .. cache_index[b]+count[b]-1``, IN PLACE.  Rows with
    ``count == 0`` are inert: their cache is untouched bit for bit.
    Returns ``(logits (B, padded_vocab), cache)`` with row b's logits
    taken at its last valid lane; rows with ``count == 0`` return
    garbage logits that callers must not read.

    Every chunk runs through the same static ``(B, C)`` buffer and each
    query attends over the full cache, so chunked prefill is bitwise
    equal to whole-prompt prefill.  Only full-cache attention families
    (dense/moe, no sliding window) are supported."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"prefill_step needs a position-indexed KV cache "
            f"(dense/moe), not family={cfg.family!r}")
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            "prefill_step writes absolute-position spans; ring-buffer "
            "(sliding-window) caches would need modular span writes")
    tokens = batch["tokens"]
    dev = tokens.device
    cache_index = torch.as_tensor(batch["cache_index"], device=dev).long()
    count = torch.as_tensor(batch["count"], device=dev).long()
    kind = _plan(cfg)[0][1]
    x = shard_act(params["embed"][tokens.long()])
    stack = params["layers"]
    for i in range(_n_layers(stack)):
        x, _ = B.layer_prefill_apply(_layer(stack, i), cfg, x,
                                     _layer(cache["layers"], i),
                                     cache_index, count, kind)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    last = torch.clamp(count - 1, 0, tokens.shape[1] - 1)
    x = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    return shard_logits((x @ _head(params, cfg))[:, 0]), cache
