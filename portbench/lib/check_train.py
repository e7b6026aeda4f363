"""What decides ``correct`` in a training cell.

The plain reference (``reference/decoder.py``) follows the program's
first checked steps from the same weights and batches: float32, TF32
off, the configuration's mixture capacity and dispatch on each
microbatch as the program routes it, and AdamW written out from the
traffic's settings.  Three numbers are compared, each against the limit
the traffic file states:

* ``loss``: the largest gap of a checked step's loss, relative to the
  reference's;
* ``grad``: by the worst leaf, the gap between the norms of the gradient
  AdamW got in step 1 (before its global clip, so that one leaf's gap
  does not reach every other leaf through the clip), relative to the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; ``grad_median``: the median leaf's gap;
* ``change``: the same of each master weight's change over the checked
  steps, over the leaves whose step-1 gradient in the reference is at
  least a thousandth of the median leaf's (the others move by round-off
  alone);
* ``change_median``: the median over those leaves of the same gap, steady
  from seed to seed where the worst leaf is not (PERF.md).

Which of them decide ``correct`` is the cell's limits file.
"""

from __future__ import annotations

import statistics

import torch

from ..reference import decoder as R
from . import weights as W
from .train import batch_at


def reference_steps(model: dict, traffic: dict, seed: int, device="cuda",
                    quant=None, fault=None) -> dict:
    """The reference's losses, step-1 gradient norms and changes, keyed as
    ``Trainer.checked_steps``.  ``quant`` computes it a precision lower
    (the control); ``fault`` plants one of the faults the comparison has
    to catch: "half" (half the batch left out, the mean over the rest)."""
    R.setup_precision()
    a = traffic["adamw"]
    tree = W.make_weights(model, seed, device, dtype=torch.float32)
    names = [n for n, _ in W.leaves(tree)]
    params = [p.requires_grad_(True) for _, p in W.leaves(tree)]
    w0 = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    cf = model.get("moe_capacity_factor")
    M = traffic["microbatches"]
    use = M // 2 if fault == "half" else M
    b = traffic["global_batch"] // M
    losses, grads = [], None
    for k in range(traffic["checked_steps"]):
        batch = batch_at(traffic, model, seed, k, device)
        acc = [torch.zeros_like(p) for p in params]
        total = 0.0
        for i in range(use):
            tok = batch["tokens"][i * b:(i + 1) * b]
            lab = batch["labels"][i * b:(i + 1) * b]
            loss = R.loss(tree, model, tok, lab, quant, cf)
            for x, g in zip(acc, torch.autograd.grad(loss, params)):
                x.add_(g)
            total += float(loss.detach())
            del loss
        losses.append(total / use)
        with torch.no_grad():
            g = [x / use for x in acc]
            del acc
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            clip = min(1.0, a["grad_clip"] / max(float(norm), 1e-9))
            step = k + 1
            lr = a["lr"] * min(1.0, step / a["warmup_steps"])
            bc1, bc2 = 1 - a["b1"] ** step, 1 - a["b2"] ** step
            if k == 0:
                grads = {n: float(torch.linalg.vector_norm(x))
                         for n, x in zip(names, g)}
            for p, x, mm, vv in zip(params, g, m, v):
                x = x * clip
                mm.mul_(a["b1"]).add_(x, alpha=1 - a["b1"])
                vv.mul_(a["b2"]).addcmul_(x, x, value=1 - a["b2"])
                p.sub_(lr * ((mm / bc1) / (torch.sqrt(vv / bc2) + a["eps"])
                             + a["weight_decay"] * p))
            del g
    change = {n: float(torch.linalg.vector_norm(p.detach() - p0))
              for n, p, p0 in zip(names, params, w0)}
    return {"loss": losses, "grad": grads, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers of the module docstring, with the leaf that set
    each of the two by leaf."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    grad, g_at = max((abs(prog["grad"][n] - r) / max(r, g_med), n)
                     for n, r in ref["grad"].items())
    moved = [n for n, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)
    change, c_at = max((abs(prog["change"][n] - ref["change"][n])
                        / max(ref["change"][n], c_med), n) for n in moved)
    by_grad = {n: abs(prog["grad"][n] - r) / max(r, g_med)
               for n, r in ref["grad"].items()}
    by_change = {n: abs(prog["change"][n] - ref["change"][n])
                 / max(ref["change"][n], c_med) for n in moved}
    return {"loss": loss, "grad": grad, "grad_leaf": g_at,
            "change": change, "change_leaf": c_at,
            "grad_median": statistics.median(by_grad.values()),
            "change_median": statistics.median(by_change.values()),
            "grad_by_leaf": by_grad, "change_by_leaf": by_change}
