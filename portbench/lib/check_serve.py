"""What decides ``correct`` in a serving cell.

Once the window has closed, a sample of the requests it finished, drawn
from the seed with the longest of them always in it, until it holds
``check.served_tokens`` generated tokens.  The reference
(``reference/decoder.py``, float32, every routed pair served) runs once
over each prompt followed by its served tokens; each served token is
judged by how far its logit lies below the reference's best at its
position: the mean gap and the widest are read, and the cell's limits
file says which decide ``correct``.

The control reads the same positions a precision lower: at each, the
gap of the token that the lower precision puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import decoder as R
from . import weights as W


def sample(finished: list, seed: int, served_tokens: int) -> list:
    """``(prompt, served)`` pairs: the longest request first, then others
    in the seed's order until ``served_tokens`` are held."""
    reqs = [(list(r.prompt), list(r.tokens[len(r.prompt):]))
            for r in finished]
    if not reqs:
        return []
    longest = max(range(len(reqs)),
                  key=lambda i: len(reqs[i][0]) + len(reqs[i][1]))
    rng = np.random.Generator(np.random.PCG64(int(seed) + 2))
    order = [longest] + [i for i in rng.permutation(len(reqs))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= served_tokens:
            break
        out.append(reqs[i])
        n += len(reqs[i][1])
    return out


def _logits(w, model, prompt, served, quant):
    seq = torch.tensor(prompt + served[:-1],
                       device=w["embed"].device)[None]
    with torch.no_grad():
        lg = R.forward(w, model, seq, quant)[0, len(prompt) - 1:]
    return lg[:, :model["vocab"]]


def gaps(model: dict, seed: int, reqs: list, device="cuda",
         quant=None) -> dict:
    """Over the served tokens of ``reqs``: the widest gap (``served``),
    the mean gap (``served_mean``) and the share of tokens that are not
    the reference's best (``served_flips``); with ``quant``, the same of
    the tokens the lower precision puts first (``control``,
    ``control_mean``, ``control_flips``)."""
    R.setup_precision()
    w = W.make_weights(model, seed, device, dtype=torch.float32)
    served, ctrl = [], []
    for prompt, toks in reqs:
        ref = _logits(w, model, prompt, toks, None)
        best = ref.max(-1).values
        tok = torch.tensor(toks, device=ref.device)
        served.append(best - ref.gather(1, tok[:, None])[:, 0])
        if quant is not None:
            pick = _logits(w, model, prompt, toks, quant).argmax(-1)
            ctrl.append(best - ref.gather(1, pick[:, None])[:, 0])
    out = {"tokens": sum(len(t) for _, t in reqs), "requests": len(reqs)}
    for name, parts in (("served", served), ("control", ctrl)):
        if parts:
            g = torch.cat(parts)
            out[name] = float(g.max())
            out[name + "_mean"] = float(g.mean())
            out[name + "_flips"] = float((g > 0).float().mean())
    return out
