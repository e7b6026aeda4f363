"""Plain PyTorch reference of the ``moe`` family (granite-moe-1b-a400m):
pre-norm blocks of causal GQA attention and a top-k mixture of SwiGLU
experts.

Routing is a softmax over the router's logits, the k largest
probabilities (ties to the lower expert) renormalised.  With a
``capacity_factor`` each expert holds ``C = max(8, ceil8(ceil(T·k/E·cf)))``
of the call's ``T`` tokens, slots counted choice-major (every token's
first choice before any second choice), and the pairs past ``C`` are
dropped (``dispatch`` "lc") or, under "dlbc", re-routed once to the
token's most probable expert that still has room after round one, at
that expert's probability, admitted while slots remain.  Without it
(``capacity_factor=None``) every pair is served.  Nothing here imports
the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .decoder import _mm, attention, decoder_forward, rmsnorm


def _capacity(T, E, k, cf):
    c = int(math.ceil(T * k / E * cf))
    return max(8, (c + 7) // 8 * 8)


def _slots(ids, E, base):
    """Choice-major running slot of each (token, choice) in its expert,
    after ``base[e]`` slots already taken; ids (T, K)."""
    flat = ids.t().reshape(-1)
    onehot = F.one_hot(flat, E)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    return (pos + base[flat]).view(ids.shape[1], -1).t()


def route(p, model, x, capacity_factor):
    """(ids, gates, keep) of every (token, choice), x (T, d)."""
    E, K = model["n_experts"], model["top_k"]
    probs = torch.softmax(x @ p["router"], -1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :K] / top[:, :K].sum(-1, keepdim=True).clamp(min=1e-9)
    ids = ids[:, :K]
    if capacity_factor is None:
        return ids, gates, torch.ones_like(ids, dtype=torch.bool)
    T = x.shape[0]
    C = _capacity(T, E, K, capacity_factor)
    zero = torch.zeros(E, dtype=torch.long, device=x.device)
    keep = _slots(ids, E, zero) < C
    if model.get("moe_dispatch", "dlbc") != "dlbc":
        return ids, gates, keep
    load = torch.bincount(ids[keep], minlength=E)
    open_ = (C - load) > 0
    over = ~keep
    alt = torch.argmax(probs * open_.to(probs.dtype), -1)     # first max
    ids2 = torch.where(over, alt[:, None], ids)
    # slots of the re-routed pairs only, after round one's load
    tagged = torch.where(over, ids2, E)
    pos2 = _slots(tagged, E + 1, torch.cat([load, zero[:1]]))
    keep2 = torch.where(over, pos2 < C, keep)
    gates2 = torch.where(over, probs.gather(1, ids2), gates)
    return ids2, gates2, keep2


def moe(p, model, x, quant, capacity_factor):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    ids, gates, keep = route(p, model, x, capacity_factor)
    out = torch.zeros_like(x)
    for e in range(model["n_experts"]):
        tok, ch = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(_mm(xe, p["w1"][e], quant)) * _mm(xe, p["w3"][e], quant)
        y = _mm(h, p["w2"][e], quant) * gates[tok, ch][:, None]
        out = out.index_add(0, tok, y)
    return out.view(shape)


def block(p, model, x, quant, capacity_factor):
    x = x + attention(p["attn"], model, rmsnorm(x, p["ln1"]["scale"]),
                      quant)
    h = rmsnorm(x, p["ln2"]["scale"])
    return x + moe(p["moe"], model, h, quant, capacity_factor)


def forward(w, model, tokens, quant=None, capacity_factor=None,
            remat=False):
    return decoder_forward(block, w, model, tokens, quant, capacity_factor,
                           remat)
