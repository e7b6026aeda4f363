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

On a mesh whose ``"model"`` axis is ``m > 1`` (:func:`forward`,
:func:`loss_fn`, :func:`decode_step`, :func:`prefill_step`; the train
step and the batcher) ``params`` is one model rank's compute shards
(``distributed.sharding.tp_local_params``): the embedding is
vocab-parallel (ids outside the rank's rows masked, then all-reduced),
the head column-parallel (the logits are this rank's vocab shard) and the
loss a vocab-parallel cross entropy.  Where ``m`` divides the sequence
(``distributed.sharding.seq_sharded``; not in decode) the residual
stream between layers is sequence-parallel, as the reference's
``shard_act`` lays it out: the embedding's partial sums are
reduce-scattered onto this rank's ``S/m`` rows, every layer gathers its
normed input and scatters its output, whisper's encoder frames and the
vlm's vision embeddings are cut to the rank's rows where their length
divides, and the head's input is gathered after the final norm.  The
caches of :func:`init_cache` are the rank's (its KV heads and
``d_inner`` channels, its rows of the batch over the data axes), and
:func:`vocab_argmax` reduces the sharded logits to the next tokens.
"""

from __future__ import annotations

import itertools
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device, torch_dtype
from ..distributed.comm import (
    copy_to_tp, expert_comm, gather_from_sp, leave_tp, model_comm,
    reduce_from_tp,
)
from ..distributed.sharding import (
    cp_local_shapes, current_mesh, data_size, expert_axis_size,
    mesh_context, model_size, seq_sharded, shard_act, shard_logits,
    tp_local_config,
)
from ..tree import tree_map
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


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors — shapes and dtypes, no storage:
    the counterpart of the reference's ``ShapeDtypeStruct`` tree (the
    train step counts its leaves for the gradient-bucket plan)."""
    return _init(cfg, L._MetaGenerator())


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


def _embed(params: dict, tokens: torch.Tensor, tp,
           sp: bool = False) -> torch.Tensor:
    """The token embeddings; with ``tp`` the embedding holds this rank's
    vocab rows: other ids give zero rows, and the ranks' rows are summed
    (with ``sp`` reduce-scattered onto this rank's block of the
    sequence)."""
    emb, tokens = params["embed"], tokens.long()
    if tp is None:
        return emb[tokens]
    V = emb.shape[0]
    local = tokens - tp.rank * V
    mine = (local >= 0) & (local < V)
    x = torch.where(mine[..., None], emb[torch.clamp(local, 0, V - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return leave_tp(x, tp, sp=sp)


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
            last_only: bool = False, tp=None, ep=None,
            dp=None) -> torch.Tensor:
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
    microbatch).  Without grad nothing is wrapped.

    ``tp``: the model-axis ``Collectives`` the tensor-parallel layers
    issue and count through; by default one over the current mesh's
    model axis when it is larger than 1 (then ``params`` are this rank's
    compute shards and the logits its vocab shard), else None.  ``ep``:
    the expert-axis ``Collectives`` the MoE layers' EP round issues and
    counts through; by default :func:`~repro_torch.distributed.comm.
    expert_comm` of the current mesh (then ``params`` may hold this
    rank's ``E/S`` experts).  Both are handed to every layer, so that a
    ``remat`` recompute, which runs where the mesh context is unset,
    takes the same path.  Where ``tp``'s size divides S the layers run
    sequence-parallel (the module docstring); the logits are whole over
    the sequence either way.  ``dp``: the data-axis ``Collectives`` when
    ``batch`` is this rank's rows of a data-parallel batch (no default):
    the MoE layers size capacity and slot positions over the whole batch
    (``moe.moe_apply``), handed to every layer like ``tp``."""
    if tp is None:
        tp = model_comm(current_mesh())
    if ep is None:
        ep = expert_comm(current_mesh(), cfg)
    sp = seq_sharded(tp, batch["tokens"].shape[1])
    x = _embed(params, batch["tokens"], tp, sp)
    kw = dict(schedule=schedule, q_chunk=q_chunk, k_chunk=k_chunk,
              ssm_chunk=ssm_chunk, tp=tp, ep=ep, sp=sp, dp=dp)
    layer = B.layer_apply
    if remat and torch.is_grad_enabled():
        def layer(*a, **k):
            return checkpoint(B.layer_apply, *a, use_reentrant=False, **k)
    if cfg.family in ("encdec", "vlm"):
        # the context is cut to this rank's rows where its length divides
        ctx = batch["enc_frames" if cfg.family == "encdec" else "vis_embed"]
        ctx_sp = seq_sharded(tp, ctx.shape[1])
        ctx = shard_act(ctx.to(x.dtype), tp)
    if cfg.family == "encdec":
        enc = ctx
        for p in _unbind(params["enc_layers"]):
            enc = layer(p, cfg, enc, "enc", causal=False,
                        **dict(kw, sp=ctx_sp))
        ctx = L.norm_apply(params["enc_norm"], enc, cfg.norm)
        for p in _unbind(params["dec_layers"]):
            x = layer(p, cfg, x, "dec", ctx=ctx, ctx_sp=ctx_sp, **kw)
    elif cfg.family == "vlm":
        for gself, gcross in zip(_unbind(params["self_layers"]),
                                 _unbind(params["cross_layers"])):
            for p in _unbind(gself):
                x = layer(p, cfg, x, "dense", **kw)
            x = layer(gcross, cfg, x, "cross", ctx=ctx, ctx_sp=ctx_sp,
                      **kw)
    else:
        kind = _plan(cfg)[0][1]
        for p in _unbind(params["layers"]):
            x = layer(p, cfg, x, kind, **kw)
    if sp:
        # the head is column-parallel: it reads the whole sequence
        x = gather_from_sp(L.norm_apply(params["final_norm"], x, cfg.norm),
                           tp)
        x = x[:, -1:] if last_only else x
    else:
        x = copy_to_tp(L.norm_apply(params["final_norm"],
                                    x[:, -1:] if last_only else x,
                                    cfg.norm), tp)
    return shard_logits(x @ _head(params, cfg))


def loss_fn(params, cfg, batch, tp=None, **kw):
    """Mean next-token cross entropy; vocab-padding logits are masked out
    of the partition function.  With a model axis (``tp`` as in
    :func:`forward`) the cross entropy is vocab-parallel: the logits'
    maximum, the sum of exponentials and the gold logit are all-reduced
    over the model ranks, the padding masked on global vocab ids."""
    if tp is None:
        tp = model_comm(current_mesh())
    logits = forward(params, cfg, batch, tp=tp, **kw).float()
    labels = batch["labels"].long()
    V = logits.shape[-1]
    lo = 0 if tp is None else tp.rank * V
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(lo, lo + V, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(logz - gold)
    mx = tp.all_reduce(logits.detach().amax(dim=-1), op="max")
    logz = torch.log(reduce_from_tp(
        torch.exp(logits - mx[..., None]).sum(dim=-1), tp)) + mx
    local = labels - lo
    mine = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1,
                        torch.clamp(local, 0, V - 1)[..., None])[..., 0]
    gold = reduce_from_tp(torch.where(mine, gold, 0.0), tp)
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, bsz: int, cache_len: int,
               device: Optional[Union[str, torch.device]] = None,
               mesh=None, context: bool = False) -> dict:
    """Zero caches on ``device`` (``None`` = the card), the reference's
    tree: per stack, leaves with its leading layer dims — KV ``{"k",
    "v"}`` of shape ``(L, bsz, T, KV, dh)`` for self attention (a
    sliding-window config keeps only the window, a ring buffer; vlm's
    ``self_layers`` lead with ``(g, k-1)``) and ``{"conv" (L, bsz, cw-1,
    Di), "h" (L, bsz, Di, N) fp32}`` for the mamba heads; no entry for
    the encoder stack and ``{}`` for vlm's cross layers.  encdec and vlm
    add ``cross_kv`` {"k", "v"}, the cross layers' K/V over the encoder
    output or the vision embeddings, ``(n_layers, bsz, enc_seq, KV, dh)``
    or ``(g, bsz, vis_seq, KV, dh)``, zero-filled: the caller fills it.

    On ``mesh`` (default: the current mesh) of data size ``D`` (the fsdp
    axes) and model size ``m``, the caches are this rank's: ``bsz / D``
    rows, and the shapes of ``distributed.sharding.tp_local_config(cfg,
    m)`` — ``KV / m`` heads where attention splits, the one KV head its
    query heads read where ``KV < m`` (then ``m / KV`` ranks hold a copy
    of each head: the whole cache's KV memory ``m / KV`` times over), all
    heads where they do not split (hymba-1.5b's 25 over 2), ``d_inner /
    m`` channels of ``conv`` and ``h``, ``cross_kv`` over the rank's KV
    heads (``distributed.sharding.tp_local_cache`` cuts a whole cache so,
    ``tp_assemble_cache`` puts one back together).

    ``context``: on a mesh, the reference's layout instead
    (``launch/dryrun.py`` ``_cache_shardings``,
    ``distributed.sharding.cache_layout``): the self-attention KV leaves
    hold this rank's block ``T/c`` of the time axis over the ``c`` ranks
    of the axes that carry it (``"model"``, or the data axes and
    ``"model"`` where the batch does not split over the data axes), with
    every KV head where ``T`` is over ``"model"``; the batch's ``B/D`` rows
    where ``D`` divides it, else all ``B`` on every data rank (the mamba
    leaves and ``cross_kv`` too, which keep their ``Di`` and head split).
    ``sharding.cp_local_cache`` cuts a whole cache so,
    ``cp_assemble_cache`` puts one back together; :func:`decode_step`
    reads it with ``cp=``."""
    mesh = mesh if mesh is not None else current_mesh()
    dev = resolve_device(device)
    if mesh is not None and context:
        # the whole tree as storage-less meta tensors (``empty``: no
        # operation for the dry run's counter), this rank's block shapes
        whole = _cache_tree(cfg, bsz, cache_len, torch.empty, "meta")
        return tree_map(lambda n, t: torch.zeros(n, dtype=t.dtype,
                                                 device=dev),
                        cp_local_shapes(whole, cfg, mesh), whole)
    if mesh is not None:
        D = data_size(mesh)
        if bsz % D:
            raise ValueError(f"batch of {bsz} rows does not split over "
                             f"{D} data ranks")
        cfg = tp_local_config(cfg, model_size(mesh), expert_axis_size(mesh))
        bsz //= D
    return _cache_tree(cfg, bsz, cache_len, torch.zeros, dev)


def _cache_tree(cfg: ModelConfig, bsz: int, cache_len: int, new,
                device) -> dict:
    """:func:`init_cache`'s tree of ``cfg``'s shapes, each leaf made by
    ``new(shape, dtype=..., device=device)``."""
    dt = torch_dtype(cfg.dtype)
    out = {}
    for name, kind, n, inner in _plan(cfg):
        if kind == "enc":
            continue
        lead = (n, inner) if inner else (n,)
        out[name] = {k: new(lead + tuple(s.shape), dtype=s.dtype,
                            device=device)
                     for k, s in B.layer_cache_shapes(
                         cfg, kind, bsz, cache_len, dt).items()}
    if cfg.family in ("encdec", "vlm"):
        n, T = (cfg.n_layers, cfg.enc_seq) if cfg.family == "encdec" \
            else (cfg.n_layers // cfg.cross_every, cfg.vis_seq)
        shape = (n, bsz, T, cfg.n_kv_heads, cfg.head_dim)
        out["cross_kv"] = {"k": new(shape, dtype=dt, device=device),
                           "v": new(shape, dtype=dt, device=device)}
    return out


def cache_shapes(cfg: ModelConfig, bsz: int, cache_len: int) -> dict:
    """The whole cache tree of :func:`init_cache` as meta tensors, on no
    mesh (the reference's ``cache_shapes``)."""
    with mesh_context(None):
        return init_cache(cfg, bsz, cache_len, device="meta")


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                batch: dict, tp=None, ep=None, dp=None, cp=None) -> tuple:
    """One token for every sequence against the cache.

    batch = {"tokens": (B, 1), "cache_index": () or (B,)} — returns
    (logits (B, padded_vocab), cache), the cache updated IN PLACE.
    encdec and vlm read the cross layers' K/V from ``cache["cross_kv"]``
    (decoder layer ``i`` or group ``gi``).

    ``tp``: the model-axis ``Collectives`` (default, as in
    :func:`forward`: one over the current mesh's model axis when it is
    larger than 1).  With it ``params`` are this rank's compute shards,
    ``cache`` this rank's (:func:`init_cache` on the mesh) and ``batch``
    this rank's rows; the logits are its vocab shard, ``(B,
    padded_vocab / m)`` (:func:`vocab_argmax` picks the tokens).  ``ep``:
    the expert-axis ``Collectives`` of the MoE layers' EP round (default,
    as in :func:`forward`, :func:`~repro_torch.distributed.comm.
    expert_comm` of the current mesh); beside a model axis the round runs
    inside the tensor-parallel region, ``params`` holding this rank's
    ``E/S`` experts × ``d_ff/m``, and the ``B`` rows of this data rank
    (alike on its expert and model ranks) are padded to a multiple of the
    expert axis inside the round.  ``dp``: the data-axis ``Collectives``
    when ``batch`` is this data rank's rows (as in :func:`forward`).

    ``cp``: the ``Collectives`` over the mesh axes that carry the
    self-attention caches' time axis (context parallelism: ``cache`` from
    ``init_cache(..., context=True)``, ``comm.context_comm`` of its
    layout's time axes).  Each rank attends over its block of ``T``, the
    partial softmax sums combined over ``cp``, and writes the new token's
    K/V only where its block holds the position
    (:func:`~repro_torch.models.blocks.layer_decode_apply`); ``batch`` is
    this data rank's rows where the batch splits over the data axes, else
    every row."""
    if tp is None:
        tp = model_comm(current_mesh())
    if ep is None:
        ep = expert_comm(current_mesh(), cfg)
    ci = batch["cache_index"]
    x = _embed(params, batch["tokens"], tp)     # S = 1: never sharded
    if cfg.family == "vlm":
        selfp, selfc = params["self_layers"], cache["self_layers"]
        for gi in range(_n_layers(params["cross_layers"])):
            gp, gc = _layer(selfp, gi), _layer(selfc, gi)
            for j in range(_n_layers(gp)):
                x, _ = B.layer_decode_apply(_layer(gp, j), cfg, x,
                                            _layer(gc, j), ci, "dense",
                                            tp=tp, ep=ep, dp=dp, cp=cp)
            x, _ = B.layer_decode_apply(
                _layer(params["cross_layers"], gi), cfg, x, {}, ci, "cross",
                ctx_kv=_layer(cache["cross_kv"], gi), tp=tp, ep=ep, dp=dp)
    elif cfg.family == "encdec":
        stack = params["dec_layers"]
        for i in range(_n_layers(stack)):
            x, _ = B.layer_decode_apply(
                _layer(stack, i), cfg, x, _layer(cache["dec_layers"], i), ci,
                "dec", ctx_kv=_layer(cache["cross_kv"], i), tp=tp, ep=ep,
                dp=dp, cp=cp)
    else:
        kind = _plan(cfg)[0][1]
        stack = params["layers"]
        for i in range(_n_layers(stack)):
            x, _ = B.layer_decode_apply(_layer(stack, i), cfg, x,
                                        _layer(cache["layers"], i), ci, kind,
                                        tp=tp, ep=ep, dp=dp, cp=cp)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return shard_logits((copy_to_tp(x, tp) @ _head(params, cfg))[:, 0]), \
        cache


def prefill_step(params: dict, cfg: ModelConfig, cache: dict,
                 batch: dict, tp=None, ep=None, dp=None) -> tuple:
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
    (dense/moe, no sliding window) are supported.  ``tp`` and ``ep``, and
    the params, cache, rows and logits on a mesh, as in
    :func:`decode_step`; chunked prefill stays bitwise equal to whole
    prefill there, each rank's partial sums reduced alike whatever the
    chunking.  Where the model axis divides C the span runs
    sequence-parallel (each rank's rows of the chunk between layers; the
    K/V written to the caches are the whole chunk's).  ``dp`` as in
    :func:`decode_step`."""
    if tp is None:
        tp = model_comm(current_mesh())
    if ep is None:
        ep = expert_comm(current_mesh(), cfg)
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
    sp = seq_sharded(tp, tokens.shape[1])
    x = _embed(params, tokens, tp, sp)
    stack = params["layers"]
    for i in range(_n_layers(stack)):
        x, _ = B.layer_prefill_apply(_layer(stack, i), cfg, x,
                                     _layer(cache["layers"], i),
                                     cache_index, count, kind, tp=tp, ep=ep,
                                     sp=sp, dp=dp)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    # the head is column-parallel: every row's last lane, on every rank
    x = gather_from_sp(x, tp) if sp else copy_to_tp(x, tp)
    last = torch.clamp(count - 1, 0, tokens.shape[1] - 1)
    x = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    return shard_logits((x @ _head(params, cfg))[:, 0]), cache


def vocab_argmax(logits: torch.Tensor, vocab: int, tp=None) -> torch.Tensor:
    """The next tokens (B,) int64: the argmax of each row of ``logits`` over
    the real vocab ``[0, vocab)`` (the padded tail's logits are arbitrary
    weights).  With ``tp`` the logits are this rank's vocab shard (global
    ids ``[rank·V, (rank+1)·V)``): each rank takes its shard's maximum and
    its first global id, one all-gather brings every rank's pair
    (exactly, as float64), and the largest value wins, the lowest id on a
    tie, so the result is ``torch.argmax`` over the whole row."""
    if tp is None:
        return torch.argmax(logits[:, :vocab], dim=-1)
    V = logits.shape[-1]
    lo = tp.rank * V
    real = torch.arange(lo, lo + V, device=logits.device) < vocab
    vals = torch.where(real, logits.double(), -torch.inf)
    idx = torch.argmax(vals, dim=-1)
    best = torch.gather(vals, -1, idx[:, None])[:, 0]
    pairs = tp.all_gather(torch.stack([best, (idx + lo).double()], -1)[None])
    best = pairs[..., 0].amax(dim=0)
    ids = torch.where(pairs[..., 0] == best, pairs[..., 1], torch.inf)
    return ids.amin(dim=0).long()
