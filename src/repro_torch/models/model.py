"""Model: init / forward / loss / prefill / decode for the dense and MoE
families.

Port of ``repro/models/model.py``.  Parameters are nested dicts of
tensors in the reference's layout: one stack ``params["layers"]`` whose
leaves carry a leading ``(L,)`` layer dim, so weights bridged from the
reference drop straight in.  The layer scan becomes a Python loop over
that dim; caches are ``cache["layers"] = {"k", "v"}`` of shape
``(L, B, T, KV, dh)`` and :func:`decode_step` / :func:`prefill_step`
update them IN PLACE (each layer writes through a view of its slice).
Other families raise and name their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device, torch_dtype
from . import blocks as B
from . import layers as L


def _plan(cfg: ModelConfig):
    """Stack plan: list of (name, kind, n_layers, nested_inner)."""
    if cfg.family == "dense":
        return [("layers", "dense", cfg.n_layers, 0)]
    if cfg.family == "moe":
        return [("layers", "moe", cfg.n_layers, 0)]
    item = {"ssm": "9", "hybrid": "9", "encdec": "10", "vlm": "10"}
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item "
        f"{item.get(cfg.family, '?')})")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, so writes land in place)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees: list) -> dict:
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random weights with the reference's distributions (normal embed
    ×0.02, lm_head ×d^-0.5, weights ×fan_in^-0.5, unit norm scales, fp32
    router), drawn from ``generator`` on ``device`` (``None`` = the card;
    a fresh generator seeded 0 when none is given).  Used where the
    reference cannot run, e.g. full-width weights on the card; parity
    tests bridge the reference's own weights instead."""
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dt = torch_dtype(cfg.dtype)
    out = {
        "embed": L._norm_init(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": L.norm_init(gen, cfg.d_model, cfg.norm, dt),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = L._norm_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dt)
    for name, kind, n, _ in _plan(cfg):
        out[name] = _stack([B.layer_init(gen, cfg, dt, kind)
                            for _ in range(n)])
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
            k_chunk: int = 1024, remat: bool = True,
            last_only: bool = False) -> torch.Tensor:
    """Logits for (B, S) tokens.  Self-attention runs the flash-attention
    kernel on CUDA tensors.  ``last_only`` slices to the final position
    before the lm_head matmul.  ``schedule``/``q_chunk``/``k_chunk``/
    ``remat`` are accepted for signature parity and have no effect (the
    port runs forward only, without autodiff rematerialisation)."""
    kind = _plan(cfg)[0][1]
    x = params["embed"][batch["tokens"].long()]
    stack = params["layers"]
    for i in range(_n_layers(stack)):
        x = B.layer_apply(_layer(stack, i), cfg, x, kind, schedule=schedule,
                          q_chunk=q_chunk, k_chunk=k_chunk)
    if last_only:
        x = x[:, -1:]
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return x @ _head(params, cfg)


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
    """Zero KV caches ``{"layers": {"k", "v"}}`` of shape
    ``(L, bsz, T, KV, dh)`` on ``device`` (``None`` = the card); a
    sliding-window config keeps only the window (ring buffer)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    out = {}
    for name, _, n, _ in _plan(cfg):
        T = min(cache_len, cfg.sliding_window) if cfg.sliding_window > 0 \
            else cache_len
        shape = (n, bsz, T, cfg.n_kv_heads, cfg.head_dim)
        out[name] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
    return out


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                batch: dict) -> tuple:
    """One token for every sequence against the cache.

    batch = {"tokens": (B, 1), "cache_index": () or (B,)} — returns
    (logits (B, padded_vocab), cache), the cache updated IN PLACE."""
    kind = _plan(cfg)[0][1]
    x = params["embed"][batch["tokens"].long()]
    stack = params["layers"]
    for i in range(_n_layers(stack)):
        x, _ = B.layer_decode_apply(_layer(stack, i), cfg, x,
                                    _layer(cache["layers"], i),
                                    batch["cache_index"], kind)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return (x @ _head(params, cfg))[:, 0], cache


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
    x = params["embed"][tokens.long()]
    stack = params["layers"]
    for i in range(_n_layers(stack)):
        x, _ = B.layer_prefill_apply(_layer(stack, i), cfg, x,
                                     _layer(cache["layers"], i),
                                     cache_index, count, kind)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    last = torch.clamp(count - 1, 0, tokens.shape[1] - 1)
    x = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    return (x @ _head(params, cfg))[:, 0], cache
