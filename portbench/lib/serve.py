"""The serving cells: a closed loop of clients on the port's batcher.

Every client sends its next request as soon as its last one finishes,
with no think time.  The requests come from a pool whose lengths are the
traffic file's distributions at fixed quantiles in a low-discrepancy
order, so every seed serves the same sizes and any stretch of the loop
sees short and long requests alike; the seed picks where that order
starts and draws the token ids.  The
clients' first requests start part-way through their answers (the
residual of each answer length at a fixed quantile), so that the loop
starts near its steady mix of prefill and decode rather than with every
slot at the same point.

The batcher is step-synchronous (``ContinuousBatcher.step``; the step
ends when the next tokens reach the host).  After each step the harness
reads every request's tokens: a request's send time, the arrival of each
generated token and its completion are taken on the host's clock at step
boundaries.  Set-up
runs ``warmup_steps`` steps of the same loop; the window then runs whole
steps until ``seconds`` have passed.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np

from . import weights as W


def _lengths(spec: dict, n: int) -> list:
    """``n`` lengths of a clipped log-normal at the quantiles
    (i + 0.5) / n: the same sizes for every seed."""
    nd = statistics.NormalDist()
    mu = math.log(spec["median"])
    return [int(min(spec["max"], max(spec["min"], round(math.exp(
        mu + spec["sigma"] * nd.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def _spread_order(n: int, step: float) -> list:
    """A permutation of ``range(n)`` whose consecutive entries spread over
    the whole range: the ranks of frac(i·step), i < n (step irrational)."""
    keys = [(i * step) % 1.0 for i in range(n)]
    return sorted(range(n), key=keys.__getitem__)


def request_pool(traffic: dict, vocab: int, seed: int) -> list:
    """``(prompt, max_new)`` of the pool, in the seed's order.  Every seed
    gets the same sizes (fixed quantiles) in the same low-discrepancy
    order, so that any run of consecutive requests holds short and long
    ones alike; the seed picks where in that order the run starts and
    draws the token ids."""
    n = traffic["pool"]
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    prompts = _lengths(traffic["prompt"], n)
    outs = _lengths(traffic["output"], n)
    rank_p = _spread_order(n, 0.6180339887498949)
    rank_o = _spread_order(n, 0.4142135623730951)
    start = int(rng.integers(0, n))
    pool = []
    for i in range(n):
        j = (start + i) % n
        L = prompts[rank_p[j]]
        pool.append((rng.integers(0, vocab, L).tolist(), outs[rank_o[j]]))
    return pool


class Server:
    """The batcher, its clients, and what the host saw of each request."""

    def __init__(self, cell, seed: int, device="cuda"):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.serve.batcher import ContinuousBatcher, Request

        self.Request = Request
        self.model, self.traffic = cell.config["model"], cell.traffic
        t = self.traffic
        self.cfg = ModelConfig(**self.model)
        self.params = W.make_weights(self.model, seed, device)
        self.b = ContinuousBatcher(
            self.cfg, self.params, n_slots=t["n_slots"],
            cache_len=t["cache_len"], policy=t["policy"],
            prefill_chunk=t["prefill_chunk"], device=device)
        self.pool = request_pool(t, self.model["vocab"], seed)
        self.next = 0
        self.now = 0
        self.live = {}          # rid -> Request, sent and not finished
        self.sent = {}
        self.times = {}         # rid -> arrival time of each new token
        self.finished = []      # Requests in completion order
        n = t["clients"]
        t0 = time.perf_counter()
        for c in _spread_order(n, 0.7548776662466927):
            self._send(t0, (c + 0.5) / n)

    def _send(self, at: float, residual: float = 1.0):
        prompt, out = self.pool[self.next % len(self.pool)]
        rid = self.next
        self.next += 1
        r = self.Request(rid=rid, prompt=list(prompt),
                         max_new=max(1, math.ceil(out * residual)),
                         arrive_step=self.now)
        self.b.submit(r)
        self.live[rid] = r
        self.sent[rid] = at
        self.times[rid] = []

    def step(self):
        """One batcher step, then what the host saw at its end."""
        start = time.perf_counter()
        self.b.step(self.now)
        self.now += 1
        end = time.perf_counter()
        for rid, r in list(self.live.items()):
            new = len(r.tokens) - len(r.prompt) - len(self.times[rid]) \
                if r.start_step is not None else 0
            self.times[rid].extend([end] * max(0, new))
            if r.done_step is not None:
                self.finished.append(r)
                del self.live[rid]
                self._send(end)
        return start, end

    def counters(self) -> dict:
        s = self.b.stats
        return {"prefill_tokens": self.b.sched.telemetry.prefill_tokens,
                "failed": s.failed + s.expired + s.truncated}

    def window(self, seconds: float) -> dict:
        """Whole steps until ``seconds`` have passed; the window's samples
        over all its requests."""
        c0 = self.counters()
        t0 = time.perf_counter()
        n0 = len(self.finished)
        steps = 0
        while True:
            _, end = self.step()
            steps += 1
            if end - t0 >= seconds:
                break
        t1 = end
        c1 = self.counters()
        ttft, itl, gen = [], [], 0
        for rid, ts in self.times.items():
            if not ts:
                continue
            if t0 < ts[0] <= t1:
                ttft.append(ts[0] - self.sent[rid])
            gen += sum(1 for x in ts if t0 < x <= t1)
            itl += [b - a for a, b in zip(ts, ts[1:]) if t0 < b <= t1]
        return {"seconds": t1 - t0, "steps": steps, "ttft_s": ttft,
                "itl_s": itl, "generated": gen,
                "finished": self.finished[n0:],
                "failed": c1["failed"] - c0["failed"],
                "prefill_tokens": c1["prefill_tokens"] - c0["prefill_tokens"]}

    def free(self):
        del self.b, self.params


def p95(xs: list) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 95))
