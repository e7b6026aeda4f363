#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then drives the port with
random weights made from a seed, at the full width of
granite-moe-1b-a400m (24 layers, d_model 1024, 32 experts top-8):

1. ``card``: the card's name and power limit from ``nvidia-smi``.
2. ``moe_gmm``: the kernel against its plain PyTorch version at the
   serving shapes (E=32, d=1024, f=512, C=8 per decode step and C=80 per
   prefill round), bf16 and fp32, with times of the kernel, the plain
   version and a ``torch.bmm`` chain, and the least time the card could
   take for the same work.
3. ``flash_attention``: the same at (B=1, S=2048, H=16, KV=8, dh=64),
   causal and with a 256 window, bf16 and fp32 (library: SDPA).
4. ``forward`` (fp32, TF32 off): the whole-sequence forward's argmax on
   a 256-token prompt equals the prefill + decode argmax; the dense
   qwen2.5 SMOKE model's chunked prefill equals its whole prefill
   bitwise under deterministic algorithms.
5. ``serve`` (bf16): ``repro_torch.launch.serve.main`` through its CLI,
   and a ContinuousBatcher run of 16 requests with 128–384-token
   prompts, 32-token chunks and 32 new tokens each on 8 slots; every
   request must finish and ``moe_gmm`` must launch 24 times per prefill
   round and per decode step.

Each main-path run (the forward of phase 4 for ``flash_attention``; the
serve CLI and the batcher run of phase 5 for ``moe_gmm``, whose CLI count
goes into the ``kernels`` line) zeroes the launch counters just before it
and reads them just after; launches made to compare a kernel with its
plain version are not counted.  Every phase prints one JSON line
and raises on failure.  The second-to-last line is the ``kernels`` JSON
and the last line ``{"ok": true, "device": {...}}``.  Without a CUDA
card, or without the package beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, FLOP/s per type.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, out, ref, atol, rtol, what):
    """max |Δ|; raises unless |Δ| <= atol + rtol·|ref| everywhere."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite or mis-shaped output")
    diff = (out - ref).abs()
    if not bool((diff <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"{what}: max |Δ| {float(diff.max())} beyond "
                             f"atol {atol} rtol {rtol}")
    return float(diff.max())


# ---------------------------------------------------------------------------
# Phase 2: moe_gmm
# ---------------------------------------------------------------------------


def phase_moe_gmm(torch, cfg) -> list:
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    # C = 8: a decode step of 8 slots; C = 80: a prefill round of 8 x 32
    # tokens; C = 256 (fp32): the 256-token forward of phase 4
    for dtype, caps in (("bfloat16", (8, 80)), ("float32", (8, 80, 256))):
        dt = getattr(torch, dtype)
        w1 = (torch.randn(E, d, f, generator=gen, device="cuda")
              * d ** -0.5).to(dt)
        w3 = (torch.randn(E, d, f, generator=gen, device="cuda")
              * d ** -0.5).to(dt)
        w2 = (torch.randn(E, f, d, generator=gen, device="cuda")
              * f ** -0.5).to(dt)
        for C in caps:
            buf = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
            tol = (2e-2 if dtype == "bfloat16" else 2e-5) * 5
            out = MG.moe_gmm(buf, w1, w3, w2)
            torch.cuda.synchronize()
            err = max_err(torch, out, moe_gmm_ref(buf, w1, w3, w2), tol, tol,
                          f"moe_gmm C={C} {dtype}")

            def library():
                h = torch.nn.functional.silu(torch.bmm(buf, w1)) \
                    * torch.bmm(buf, w3)
                return torch.bmm(h, w2)
            esz = buf.element_size()
            nbytes = (2 * E * C * d + 3 * E * d * f) * esz
            b_ms, b_by = bound(nbytes, 6 * E * C * d * f, dtype)
            row = {"phase": "moe_gmm", "E": E, "C": C, "d": d, "f": f,
                   "dtype": dtype, "max_abs_err": err, "atol": tol,
                   "rtol": tol,
                   "kernel_ms": time_ms(torch, lambda: MG.moe_gmm(
                       buf, w1, w3, w2), 20),
                   "plain_ms": time_ms(torch, lambda: moe_gmm_ref(
                       buf, w1, w3, w2), 5),
                   "library_ms": time_ms(torch, library, 20),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        del w1, w3, w2
    return rows


# ---------------------------------------------------------------------------
# Phase 3: flash_attention
# ---------------------------------------------------------------------------


def attention_flops(S: int, T: int, B: int, H: int, dh: int, causal: bool,
                    window: int) -> float:
    """4·dh FLOPs per visible (query, key) pair per head, counting only
    the pairs the masks leave (what this input needs)."""
    pairs = 0
    for qp in range(S):
        hi = min(T, qp + 1) if causal else T
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo)
    return 4.0 * dh * B * H * pairs


def phase_flash(torch, cfg) -> list:
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, H, KV, dh = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    # S = 256 fp32 causal: the forward of phase 4; S = 2048: a long prompt
    for S, dtype, window in ((256, "float32", 0), (2048, "bfloat16", 0),
                             (2048, "bfloat16", 256), (2048, "float32", 0),
                             (2048, "float32", 256)):
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, dh, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KV, dh, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, KV, dh, generator=gen, device="cuda").to(dt)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        out = FA.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = max_err(torch, out, attention_ref(
            q, k, v, causal=True, window=window), tol, tol,
            f"flash_attention window={window} {dtype}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window:
            pos = torch.arange(S, device="cuda")
            mask = (pos[:, None] >= pos[None, :]) \
                & (pos[:, None] - pos[None, :] < window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        nbytes = (2 * B * S * H * dh + 2 * B * S * KV * dh) \
            * q.element_size()
        b_ms, b_by = bound(nbytes, attention_flops(
            S, S, B, H, dh, True, window), dtype)
        row = {"phase": "flash_attention", "B": B, "S": S, "H": H,
               "KV": KV, "dh": dh, "causal": True, "window": window,
               "dtype": dtype, "max_abs_err": err, "atol": tol,
               "rtol": tol,
               "kernel_ms": time_ms(torch, lambda: FA.flash_attention(
                   q, k, v, causal=True, window=window), 20),
               "plain_ms": time_ms(torch, lambda: attention_ref(
                   q, k, v, causal=True, window=window), 5),
               "library_ms": time_ms(torch, library, 20),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: forward vs prefill + decode (fp32), chunked == whole (bitwise)
# ---------------------------------------------------------------------------


def phase_forward(torch, cfg) -> dict:
    from repro_torch.device import parity_mode
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.models import model as TM

    parity_mode(deterministic=False)
    # Capacity ample (C >= T): no (token, choice) pair can be dropped, so
    # the whole-sequence forward and the prefill + decode path compute
    # the same function (drops depend on how many tokens share a launch).
    c32 = dataclasses.replace(cfg, dtype="float32",
                              moe_capacity_factor=cfg.n_experts / cfg.top_k)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = TM.init_params(c32, gen, device="cuda")
    prompt = torch.randint(0, c32.vocab, (1, 256), generator=gen,
                           device="cuda")
    MG.launches = FA.launches = 0
    fwd = TM.forward(params, c32, {"tokens": prompt}, last_only=True)[:, 0]
    torch.cuda.synchronize()
    launches = {"flash_attention": FA.launches, "moe_gmm": MG.launches}
    cache = TM.init_cache(c32, 1, 512, device="cuda")
    TM.prefill_step(params, c32, cache, {
        "tokens": prompt[:, :255],
        "cache_index": torch.zeros(1, dtype=torch.long, device="cuda"),
        "count": torch.tensor([255], device="cuda")})
    dec, _ = TM.decode_step(params, c32, cache, {
        "tokens": prompt[:, 255:], "cache_index": torch.tensor(
            [255], device="cuda")})
    V = c32.vocab
    if not (bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(dec).all())):
        raise AssertionError("forward: non-finite logits")
    a_fwd = int(fwd[0, :V].argmax())
    a_dec = int(dec[0, :V].argmax())
    top2 = torch.topk(fwd[0, :V], 2).values
    row = {"phase": "forward", "arch": cfg.name, "dtype": "float32",
           "prompt": 256, "argmax_forward": a_fwd, "argmax_decode": a_dec,
           "logits_max_abs_diff": float((fwd - dec).abs().max()),
           "top2_margin": float(top2[0] - top2[1]), "launches": launches}
    del params, cache
    if a_fwd != a_dec:
        emit(row)
        raise AssertionError("forward argmax != prefill+decode argmax")
    if launches["flash_attention"] == 0:
        raise AssertionError("forward never launched flash_attention")

    # dense qwen2.5 SMOKE: chunked == whole prefill, bitwise
    from repro_torch.configs import get_config
    dense = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                                dtype="float32")
    parity_mode(deterministic=True)
    try:
        dp = TM.init_params(dense, torch.Generator(device="cuda")
                            .manual_seed(SEED), device="cuda")
        toks = torch.randint(0, dense.vocab, (12,), generator=gen,
                             device="cuda")
        results = []
        for sizes in ([11], [1] * 11, [8, 3]):
            cache = TM.init_cache(dense, 2, 32, device="cuda")
            pos = 0
            for s in sizes:
                buf = torch.zeros((2, 16), dtype=torch.long, device="cuda")
                buf[0, :s] = toks[pos:pos + s]
                TM.prefill_step(dp, dense, cache, {
                    "tokens": buf,
                    "cache_index": torch.tensor([pos, 0], device="cuda"),
                    "count": torch.tensor([s, 0], device="cuda")})
                pos += s
            logits, _ = TM.decode_step(dp, dense, cache, {
                "tokens": torch.stack([toks[11:], toks[11:]]),
                "cache_index": torch.tensor([11, 0], device="cuda")})
            results.append((cache["layers"]["k"].clone(),
                            cache["layers"]["v"].clone(), logits[0].clone()))
        delta = max(float((a - b).abs().max())
                    for r in results[1:] for a, b in zip(r, results[0]))
    finally:
        parity_mode(deterministic=False)
    row["chunked_vs_whole_max_abs_diff"] = delta
    emit(row)
    if delta != 0.0:
        raise AssertionError(f"chunked prefill != whole prefill: {delta}")
    return row


# ---------------------------------------------------------------------------
# Phase 5: serving (bf16)
# ---------------------------------------------------------------------------


def phase_serve(torch, cfg, card: str) -> dict:
    import numpy as np

    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as TM
    from repro_torch.serve import batcher as SB

    # Count the model launches the batcher makes, so the kernel launches
    # can be held to exactly 24 (one per MoE layer) per model launch.
    calls = {"prefill": 0, "decode": 0}
    real_prefill, real_decode = TM.prefill_step, TM.decode_step

    def prefill_step(*a, **k):
        calls["prefill"] += 1
        return real_prefill(*a, **k)

    def decode_step(*a, **k):
        calls["decode"] += 1
        return real_decode(*a, **k)

    def counted_run(run) -> dict:
        calls.update(prefill=0, decode=0)
        TM.prefill_step, TM.decode_step = prefill_step, decode_step
        try:
            MG.launches = FA.launches = 0
            run()
            torch.cuda.synchronize()
            got = {"moe_gmm": MG.launches, "flash_attention": FA.launches}
        finally:
            TM.prefill_step, TM.decode_step = real_prefill, real_decode
        expect = cfg.n_layers * (calls["prefill"] + calls["decode"])
        if got["moe_gmm"] != expect or expect == 0:
            raise AssertionError(f"moe_gmm launched {got['moe_gmm']} times, "
                                 f"expected {expect}")
        return {"launches": got, "prefill_rounds": calls["prefill"],
                "decode_steps": calls["decode"]}

    # 1. the CLI entry point, as a user runs it
    printed = io.StringIO()
    cli = {}

    def run_cli():
        with contextlib.redirect_stdout(printed):
            cli.update(launch_serve.main([
                "--arch", cfg.name, "--requests", "16", "--slots", "8",
                "--cache-len", "512"]))
    t0 = time.perf_counter()
    cli_counts = counted_run(run_cli)
    cli_s = time.perf_counter() - t0
    if json.loads(printed.getvalue()) != json.loads(json.dumps(cli)):
        raise AssertionError("serve CLI printed something else than it ran")
    sched = cli["sched"]
    if sched["joins"] != 16 or sched["spawns"] != 16:
        raise AssertionError(f"serve CLI finished {sched['joins']}/16")
    emit({"phase": "serve_cli", "arch": cli["arch"], "steps": cli["steps"],
          "utilization": cli["utilization"],
          "p99_latency_steps": cli["p99_latency_steps"],
          "joins": sched["joins"], "wall_s": cli_s, **cli_counts})

    # 2. a ContinuousBatcher run: 16 requests, 128–384-token prompts
    params = TM.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED), device="cuda")
    rng = np.random.default_rng(SEED)
    reqs = [SB.Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(128, 385))).tolist(),
                max_new=32, arrive_step=0) for i in range(16)]
    b = SB.ContinuousBatcher(cfg, params, n_slots=8, cache_len=512,
                             policy="dlbc", prefill_chunk=32, device="cuda")
    step_ms = []

    def run_batcher():
        for r in reqs:
            b.submit(r)
        now = 0
        while (b.queued() or any(r is not None for r in b.slot_req)) \
                and now < 5000:
            ts = time.perf_counter()
            b.step(now)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            now += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = counted_run(run_batcher)
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.done_step is not None]
    gen_tokens = sum(len(r.tokens) - len(r.prompt) for r in reqs)
    bad = [t for r in reqs for t in r.tokens if not 0 <= t < cfg.vocab]
    row = {"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
           "card": card, "requests": len(reqs), "finished": len(done),
           "steps": len(step_ms), "generated_tokens": gen_tokens,
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "tokens_per_s": gen_tokens / wall, "wall_s": wall,
           "p50_step_ms": float(np.percentile(step_ms, 50)),
           "p99_step_ms": float(np.percentile(step_ms, 99)), **counts}
    emit(row)
    if len(done) != len(reqs) or gen_tokens != 32 * len(reqs) or bad:
        raise AssertionError("serving did not finish every request cleanly")
    row["cli_launches"] = cli_counts["launches"]
    return row


# ---------------------------------------------------------------------------


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m")
    moe_rows = phase_moe_gmm(torch, cfg)
    flash_rows = phase_flash(torch, cfg)
    fwd = phase_forward(torch, cfg)
    srv = phase_serve(torch, cfg, smi)

    moe_main = next(r for r in moe_rows
                    if r["C"] == 8 and r["dtype"] == "bfloat16")
    flash_main = flash_rows[0]
    kernels = [
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_dispatch/moe_gmm.py:46",
         "launches": srv["cli_launches"]["moe_gmm"],
         "shape": "E=32 C=8 d=1024 f=512 bf16 (decode step)",
         "max_abs_err": moe_main["max_abs_err"], "ms": moe_main["kernel_ms"],
         "plain_ms": moe_main["plain_ms"], "bound_ms": moe_main["bound_ms"],
         "bound_by": moe_main["bound_by"],
         "library_ms": moe_main["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
         "launches": fwd["launches"]["flash_attention"],
         "shape": "B=1 S=256 H=16 KV=8 dh=64 causal fp32 (forward)",
         "max_abs_err": flash_main["max_abs_err"],
         "ms": flash_main["kernel_ms"], "plain_ms": flash_main["plain_ms"],
         "bound_ms": flash_main["bound_ms"],
         "bound_by": flash_main["bound_by"],
         "library_ms": flash_main["library_ms"]},
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
