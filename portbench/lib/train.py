"""The training cells: the port's train step driven from the seed.

Set-up builds ONE train step with its weights and AdamW state (the
benchmark's weights, ``lib.weights``), drives it through the traffic's
first ``checked_steps`` steps (which also build every kernel and warm
every shape the window uses), records what the reference is held to, and
hands the same object to the window.  Each step's batch is drawn on the
card from the seed and the step's index, so every row of every step
differs and any step's batch can be drawn again.

The window runs whole steps until ``seconds`` have passed, synchronising
after each: ``train_tokens_per_s`` is the trained tokens of those steps
over the time they took.  The reference check runs after the window,
the program's state freed (``lib.check_train``).
"""

from __future__ import annotations

import time

import torch

from . import weights as W
from .device import sync


def batch_at(traffic: dict, model: dict, seed: int, i: int, device):
    """Step ``i``'s batch: (global_batch, seq_len + 1) token ids drawn from
    (seed, i), cut into tokens and next-token labels."""
    B, S = traffic["global_batch"], traffic["seq_len"]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 7919 * (i + 1)) % (2 ** 63))
    ids = torch.randint(0, model["vocab"], (B, S + 1), generator=gen,
                        device=device)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


class Trainer:
    """The program's train step, its state and its feed."""

    def __init__(self, cell, seed: int, device="cuda"):
        from repro_torch.configs.base import ModelConfig, ShapeConfig
        from repro_torch.models import model as MDL
        from repro_torch.train.optimizer import AdamWConfig, init_opt_state
        from repro_torch.train.train_step import StepConfig, build_train_step

        self.model, self.traffic = cell.config["model"], cell.traffic
        self.seed, self.device = seed, device
        t = self.traffic
        cfg = ModelConfig(**self.model)
        shape = ShapeConfig("train", t["seq_len"], t["global_batch"],
                            "train", microbatches=t["microbatches"])
        self.ocfg = AdamWConfig(**t["adamw"])
        self.params = W.make_weights(self.model, seed, device)
        want = {n: (tuple(s.shape), s.dtype)
                for n, s in W.leaves(MDL.param_shapes(cfg))}
        got = {n: (tuple(x.shape), x.dtype)
               for n, x in W.leaves(self.params)}
        if want != got:
            raise RuntimeError(f"the benchmark's weight tree differs from "
                               f"the program's: {sorted(set(want) ^ set(got))}"
                               f" or shapes/dtypes")
        self.opt = init_opt_state(self.params, self.ocfg)
        self.step_fn, _ = build_train_step(cfg, shape, StepConfig(
            policy=t["policy"], sched_policy=t["sched_policy"],
            remat=t["remat"]), self.ocfg)
        self.tokens_per_step = t["global_batch"] * t["seq_len"]
        self.i = 0
        self.skipped = []

    def step(self):
        """One optimizer step on the next batch; returns its metrics."""
        batch = batch_at(self.traffic, self.model, self.seed, self.i,
                         self.device)
        self.params, self.opt, m = self.step_fn(self.params, self.opt, batch)
        self.skipped.append(m["nonfinite_skipped"])
        self.i += 1
        return m

    def checked_steps(self) -> dict:
        """The first steps, with what the reference is held to: each
        step's loss, the gradient AdamW got in step 1 (before its global
        clip, from its first moment and the step's gradient norm), and each
        master weight's change after the last checked step (before the
        window's first step moves it)."""
        n = self.traffic["checked_steps"]
        o = self.ocfg
        w0 = [p.detach().clone() for _, p in W.leaves(self.params)]
        losses, grads = [], None
        for k in range(n):
            m = self.step()
            losses.append(m["loss"])
            if k == 0:
                # m = (1 - b1)·clip·g: undo the clip AdamW applied
                norm = float(m["grad_norm"])
                clip = o.grad_clip / norm if norm > o.grad_clip else 1.0
                grads = {name: float(torch.linalg.vector_norm(x))
                         / ((1 - o.b1) * clip)
                         for name, x in W.leaves(self.opt["m"])}
        master = self.opt.get("master", self.params)
        change = {name: float(torch.linalg.vector_norm(
            mp.float() - p0.float()))
            for (name, mp), p0 in zip(W.leaves(master), w0)}
        del w0
        return {"loss": [float(x) for x in losses], "grad": grads,
                "change": change}

    def window(self, seconds: float) -> dict:
        """Whole steps until ``seconds`` have passed."""
        sync()
        t0 = time.perf_counter()
        ends, enqueue = [], []
        while not ends or ends[-1] - t0 < seconds:
            a = time.perf_counter()
            self.step()
            enqueue.append(time.perf_counter() - a)
            sync()
            ends.append(time.perf_counter())
        steps = len(ends)
        return {"steps": steps, "seconds": ends[-1] - t0,
                "tokens": steps * self.tokens_per_step,
                "enqueue_s": enqueue,
                "skipped": int(sum(int(s) for s in self.skipped))}

    def free(self):
        del self.params, self.opt, self.step_fn
