"""Seeded weights of a configuration, made by the benchmark itself.

The same tree goes to the program under test and to the plain reference:
the benchmark makes it, neither side derives it from the other.  The
tree's layout is the decoder's published one as the program takes it
(one stack ``layers`` whose leaves lead with the layer count):

    embed (Vp, d), lm_head (d, Vp), final_norm.scale (d),
    layers.ln1.scale, layers.ln2.scale (L, d),
    layers.attn.{wq,wk,wv,wo}.w                     (attention),
    layers.<the family's own leaves>

A family's leaves are ``leaf_specs`` of ``portbench/families/<family>.py``,
found by the configuration's ``family`` (a decoder builds them with
:func:`decoder_leaves`).  Random leaves are normal with the scale beside
them (fan-in ** -0.5 for projections, 0.02 for the embedding, d ** -0.5
for the head): one ``torch.randn`` over all of them on the card, cut into
leaves and cast to the served dtype.  Norm scales are 1; leaves marked
fp32 (a router) stay float32.
"""

from __future__ import annotations

import math

import torch

from .cell import family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(model: dict) -> int:
    return (model["vocab"] + 255) // 256 * 256


def head_dim(model: dict) -> int:
    return model.get("d_head") or model["d_model"] // model["n_heads"]


def decoder_leaves(model: dict, layer: list) -> list:
    """``(path, shape, init, scale, fp32)`` of a decoder's leaves, in a
    fixed order: embedding, final norm, head, then the stack of layers,
    each of the norms, the attention and ``layer`` (the family's own
    leaves of one layer, paths and shapes without the layer axis).
    ``init`` is "randn", "ones" or "zeros"; ``fp32`` marks leaves
    kept in float32 whatever the served dtype."""
    d, L, V = model["d_model"], model["n_layers"], padded_vocab(model)
    H, KV, h = model["n_heads"], model["n_kv_heads"], head_dim(model)
    out = [(("embed",), (V, d), "randn", 0.02, False),
           (("final_norm", "scale"), (d,), "ones", 0, False),
           (("lm_head",), (d, V), "randn", d ** -0.5, False)]
    lay = [(("ln1", "scale"), (d,), "ones", 0, False),
           (("ln2", "scale"), (d,), "ones", 0, False),
           (("attn", "wq", "w"), (d, H * h), "randn", d ** -0.5, False),
           (("attn", "wk", "w"), (d, KV * h), "randn", d ** -0.5, False),
           (("attn", "wv", "w"), (d, KV * h), "randn", d ** -0.5, False),
           (("attn", "wo", "w"), (H * h, d), "randn", (H * h) ** -0.5,
            False)] + list(layer)
    return out + [(("layers",) + p, (L,) + s, i, sc, f32)
                  for p, s, i, sc, f32 in lay]


def leaf_specs(model: dict) -> list:
    """Every leaf of ``model``, as its family lays them out."""
    return family(model["family"]).leaf_specs(model)


def make_weights(model: dict, seed: int, device, dtype=None) -> dict:
    """The nested tree of ``model``'s weights from ``seed``, on
    ``device``, in ``dtype`` (default the configuration's; fp32 leaves
    stay fp32).  The values are those of the served dtype whatever
    ``dtype`` is: a float32 tree holds the bf16 weights exactly, so the
    reference computes with the program's weights."""
    served = DTYPES[model["dtype"]]
    want = DTYPES[dtype] if isinstance(dtype, str) else (dtype or served)
    specs = leaf_specs(model)
    total = sum(math.prod(s) for _, s, i, _, _ in specs if i == "randn")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, shape, init, scale, f32 in specs:
        n = math.prod(shape)
        if init == "randn":
            t = flat[at:at + n].view(shape) * scale
            at += n
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        if not f32:
            t = t.to(served)        # the served values, in either dtype
        t = t.to(torch.float32 if f32 else want)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.contiguous()
    del flat
    return tree


def leaves(tree: dict, prefix: str = "") -> list:
    """``(name, tensor)`` of every leaf, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else k
        out += leaves(v, name) if isinstance(v, dict) else [(name, v)]
    return out
