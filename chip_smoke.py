#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then drives the port with
random weights made from a seed, at the full width of
granite-moe-1b-a400m (24 layers, d_model 1024, 32 experts top-8),
falcon-mamba-7b (64 layers, d_model 4096, d_inner 8192, state 16),
hymba-1.5b (32 layers, d_model 1600, 25 heads / 5 kv heads, window 1024,
d_inner 3200), phi3-mini-3.8b (32 layers, d_model 3072, 32 heads of dim
96), mixtral-8x7b (d_model 4096, 32 heads / 8 kv heads, 8 experts
top-2 of width 14336, window 4096; 2 of its 32 layers, since its 93 GB
of bf16 weights exceed the card), whisper-medium (24 encoder and 24
decoder layers, d_model 1024, 16 heads of dim 64, 1500 frames) and
llama-3.2-vision-90b (d_model 8192, 64 heads / 8 kv heads of dim 128,
1601 patches; 10 of its 100 layers, two groups of four self layers and
one cross layer, since its ~180 GB of bf16 weights exceed the card):

1. ``card``: the card's name and power limit from ``nvidia-smi``.
2. ``moe_gmm``: the kernel pair against its plain PyTorch version at the
   serving shapes (E=32, d=1024, f=512, C=8 per decode step, C=80 per
   prefill round, C=256 per 256-token forward), bf16 and fp32, and at a
   training microbatch's C=1280 in bf16, with each
   row's launch plan (tiles, ring depth, K splits), times of the kernels,
   the plain version and a ``torch.bmm`` chain, and the least time the
   card could take for the same work (fp32: three TF32 products per
   product on the tensor cores; the CUDA cores' 67 TFLOP/s bound beside
   it).
3. ``flash_attention``: the same at (B=1, S=2048, H=16, KV=8, dh=64),
   causal and with a 256 window, bf16 and fp32, at hymba's shape
   (H=25, KV=5, window 1024) for S=256 fp32 and S=2048 bf16, at
   phi3-mini's (H=KV=32, dh=96) for S=256 fp32 and S=2048 bf16, and at
   mixtral's 512-token bf16 forward (H=32, KV=8, dh=128, window 4096)
   (library: SDPA).
4. ``fp32_forward`` (fp32, TF32 off), granite: the whole-sequence
   forward's argmax on a 256-token prompt equals the prefill + decode
   argmax, with exactly one ``flash_attention`` and one ``moe_gmm``
   launch per layer; ``chunked_prefill``: the dense qwen2.5 SMOKE
   model's chunked prefill equals its whole prefill bitwise under
   deterministic algorithms.
5. ``serve`` (bf16): ``repro_torch.launch.serve.main`` through its CLI,
   and a ContinuousBatcher run of 16 requests with 128–384-token
   prompts, 32-token chunks and 32 new tokens each on 8 slots; every
   request must finish and ``moe_gmm`` must launch 24 times per prefill
   round and per decode step.
6. ``ssm_scan``: the kernel against its plain version (fp32, 1e-4) at
   falcon's per-chunk launch (B=1, L=256, Di=8192, N=16) from a zero and
   a carried state (``h_out`` compared too), a whole 2048-token layer,
   and hymba's ragged width (B=2, L=256, Di=3200); no single PyTorch call
   computes the recurrence, so there is no library time.
7. ``fp32_forward``, falcon-mamba-7b at full depth, then hymba-1.5b:
   ``forward(last_only)`` over a 256-token prompt has the argmax of the
   same tokens fed one by one through ``decode_step``; ``ssm_scan``
   launches once per layer (64 / 32) and, for hymba,
   ``flash_attention`` too (32).
8. ``ssm_bf16``: falcon-mamba-7b in bf16, one timed 2048-token forward
   and 32 timed greedy decode steps after a 16-token prompt, finite
   logits, peak device memory.
9. phi3-mini-3.8b at full depth: ``fp32_forward`` over a 256-token
   prompt against prefill + decode (32 ``flash_attention`` launches);
   ``wide_bf16``, one timed bf16 2048-token forward with exactly 32
   launches (tensor-core path), tokens/s and peak device memory.
10. mixtral-8x7b, 2 layers: ``moe_gmm`` at its expert shape (E=8,
    d=4096, f=14336) against its plain version and the ``torch.bmm``
    chain, bf16 at C=8 (a decode step) and C=160, fp32 at C=64;
    ``fp32_forward`` over 64 tokens (capacity factor E / top_k) against
    the same tokens fed one by one through ``decode_step`` (prefill
    refuses sliding-window caches); ``wide_bf16``, one timed 512-token
    forward with exactly 2 ``moe_gmm`` and 2 ``flash_attention``
    launches.

11. ``flash_attention_bwd`` and ``moe_gmm_bwd``: the backward kernels
    against autograd through the plain versions (each gradient within
    2e-2 (bf16) or 2e-5 / 1e-4 (fp32, flash / moe) of its largest
    reference value, each tensor's error printed; the forward's output in
    grad mode within the forward's tolerance, and flash's row
    log-sum-exp too; two calls bitwise equal) at granite's training
    microbatch (flash: B 4, S 1024, causal, bf16 (tensor cores) and fp32,
    and with a 256 window; phi3's dh 96 at S 2048; hymba's training
    microbatch, B 1, S 1024, G 5, window 1024; moe: E 32, C 1280 bf16
    and fp32, and C 8), with the kernel, plain, library (SDPA's backward,
    the middle of five rounds, or the ``torch.bmm`` chain's backward) and
    bound times; ``ssm_scan_bwd``: the backward kernel against
    ``ssm_scan_bwd_ref`` and autograd through the plain scan (each output
    within 1e-5 of its largest reference value, two calls bitwise equal)
    at hymba's and falcon's chunks, with and without ``h0`` and
    ``dh_last``.  Each backward row prints its plan (``moe_gmm``'s
    ``backward_plan``: tiles, ring stages, shared memory and grid of the
    four GEMMs; ``ssm_scan``'s ``bwd_plan``: blocks, clusters, shared
    memory and the dC scratch).
12. ``train_grads``: granite at full width, 2 layers, fp32: one
    ``loss_fn`` backward on the card against the same weights' gradients
    on the CPU — the same expert routes first, then every gradient within
    1e-4 of its largest CPU value.
13. ``train``: granite at full width (24 layers, bf16) through
    ``build_train_step`` + ``init_opt_state``: seq 1024, global batch 8 in
    2 microbatches, policy ``afe``, sched policy ``dlbc``, four AdamW steps
    on one batch (lr 1e-4, warmup 1): finite, falling losses, no skipped
    step, step time, tokens/s, peak memory, and exactly 24 × 2 launches of
    each kernel and each backward kernel per step; ``train_cli``:
    ``repro_torch.launch.train`` (8 smoke steps, checkpoints every 2, a
    crash after step 5, then the same run resumes from step 4) against an
    uninterrupted run, final losses within 1e-5.
14. hymba-1.5b training: ``train_grads`` at full width, 2 layers, fp32,
    the scan in two chained 128-token chunks; ``train`` at full width (32
    layers, bf16), seq 1024, global batch 8 in 8 microbatches, four AdamW
    steps, with exactly 32 × 8 launches of ``flash_attention`` and its
    backward and 32 × 4 × 8 of ``ssm_scan`` and its backward per step.
15. whisper-medium: ``flash_attention`` and its backward at its shapes
    (the encoder's non-causal S = T = 1500 at B 1 and at a training
    microbatch's B 4, cross attention of 448 decoder positions against
    1500 frames, bf16 and fp32, causal decoder self attention at S 448),
    and the vlm's cross attention (S 512 against T 1601, G 8, dh 128),
    each held against the plain version with the kernel, plain, SDPA and
    bound times; ``fp32_forward`` at full width and depth:
    ``forward(last_only)`` over 64 tokens and seeded frames against the
    tokens fed one by one through ``decode_step``, ``cross_kv`` filled
    from the encoder output, with exactly 24 non-causal encoder, 24
    causal decoder and 24 cross ``flash_attention`` launches;
    ``train_grads`` at 2 + 2 layers (B 2, S 64, 1500 frames) against the
    CPU; ``train``: four bf16 AdamW steps at seq 448, global batch 8 in 2
    microbatches, 72 launches of ``flash_attention`` and of its backward
    per microbatch.
16. llama-3.2-vision-90b (10 layers): ``fp32_forward`` over 64 tokens
    and seeded patch embeddings against decode (8 causal self and 2
    cross launches), and ``wide_bf16``, a timed 512-token forward with
    10 ``flash_attention`` launches.

Each main-path run (each forward of phases 4, 7, 9, 10, 15 and 16; the
serve CLI and the batcher run of phase 5 for ``moe_gmm``; the four steps
of phases 13, 14 and 15 for the backward kernels) zeroes the launch counters
just before it and reads them just after; the ``kernels`` line takes ``moe_gmm``'s
count from the serve CLI, ``ssm_scan``'s from the fp32 falcon-mamba-7b
forward, ``flash_attention``'s from the bf16 phi3-mini forward,
``flash_attention_bwd``'s and ``moe_gmm_bwd``'s from phase 13 (and a
second ``flash_attention_bwd`` entry, at whisper's cross-attention shape,
from phase 15) and ``ssm_scan_bwd``'s from phase 14.  Each
phase's wall time is printed after it.  Launches made to compare a kernel with its plain
version are not counted.  Every phase prints JSON lines and raises on
failure.  The second-to-last line is the ``kernels`` JSON and the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, FLOP/s per type
# (float32: the CUDA cores; tf32: the tensor cores).
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def timed(phase, *args):
    """Run ``phase(*args)`` and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase": "seconds", "of": phase.__name__[len("phase_"):],
          "seconds": time.perf_counter() - t0})
    return out


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


def phase_moe_gmm(torch, cfg, plan) -> list:
    """``plan``: (dtype, capacities) pairs at ``cfg``'s expert shape."""
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype, caps in plan:
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
            flops = 6 * E * C * d * f
            # fp32 runs as three TF32 products on the tensor cores (3xTF32)
            b_ms, b_by = bound(nbytes, 3 * flops, "tf32") \
                if dtype == "float32" else bound(nbytes, flops, dtype)
            launch = MG.launch_plan(E, C, d, f, dt, n_sms)
            row = {"phase": "moe_gmm", "arch": cfg.name, "E": E, "C": C,
                   "d": d, "f": f, "dtype": dtype,
                   "plan": {k: g._asdict() for k, g in
                            launch._asdict().items()},
                   "max_abs_err": err, "atol": tol, "rtol": tol,
                   "kernel_ms": time_ms(torch, lambda: MG.moe_gmm(
                       buf, w1, w3, w2), 20),
                   "plain_ms": time_ms(torch, lambda: moe_gmm_ref(
                       buf, w1, w3, w2), 5),
                   "library_ms": time_ms(torch, library, 20),
                   "bound_ms": b_ms, "bound_by": b_by}
            if dtype == "float32":
                row["bound_cuda_cores_ms"] = bound(nbytes, flops, dtype)[0]
            emit(row)
            rows.append(row)
            del buf, out
        del w1, w3, w2
        torch.cuda.empty_cache()
    return rows


def grads_against_plain(torch, fn, ref_fn, args, dout, names, fwd_tol, tol,
                        what):
    """``fn(*args)`` (the kernel, in grad mode) and the gradients of
    ``(fn(*args) * dout).sum()`` (its backward kernels) against the plain
    version ``ref_fn`` under autograd, on fp32 copies of the same inputs.
    The forward output must be within ``fwd_tol`` (atol and rtol, as the
    forward phases hold it) and each gradient within ``tol × max
    |reference gradient|`` of that tensor; a second call must give the
    same bits.  Returns (max |Δ| of the gradients, {name: max |Δ| / max
    |ref|}, the forward's max |Δ|, the fp32 graph of the plain version,
    its inputs)."""
    def run():
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        out = fn(*leaves)
        out.backward(dout)
        return out.detach(), [a.grad for a in leaves]
    (out, got), (out2, again) = run(), run()
    torch.cuda.synchronize()
    if not (torch.equal(out, out2)
            and all(torch.equal(a, b) for a, b in zip(got, again))):
        raise AssertionError(f"{what}: two calls differ")
    ref_in = [a.detach().float().requires_grad_(True) for a in args]
    ref_out = ref_fn(*ref_in).float()
    fwd_err = max_err(torch, out, ref_out.detach().to(out.dtype), fwd_tol,
                      fwd_tol, f"{what} forward")
    ref = torch.autograd.grad(ref_out, ref_in, dout.float(),
                              retain_graph=True)
    err, rel = 0.0, {}
    for name, g, r in zip(names, got, ref):
        r = r.to(g.dtype).float()
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: {name} non-finite or mis-shaped")
        e, scale = float((g.float() - r).abs().max()), float(r.abs().max())
        if e > tol * scale:
            raise AssertionError(f"{what}: {name} max |Δ| {e} beyond "
                                 f"{tol} × {scale}")
        err, rel[name] = max(err, e), e / max(scale, 1e-30)
    return err, rel, fwd_err, ref_out, ref_in


def phase_moe_gmm_bwd(torch, cfg, plan) -> list:
    """The backward kernels of ``moe_gmm`` (dbuf, dw1, dw3, dw2), and the
    forward kernels that run in grad mode, against autograd through the
    plain version, at ``cfg``'s expert shape.  Each gradient is held
    within 2e-2 (bf16) or 1e-4 (fp32) of its largest reference value: the
    bf16 limit is ``flash_attention``'s, tighter than the forward's."""
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for dtype, caps in plan:
        dt = getattr(torch, dtype)
        w1, w3 = ((torch.randn(E, d, f, generator=gen, device="cuda")
                   * d ** -0.5).to(dt) for _ in range(2))
        w2 = (torch.randn(E, f, d, generator=gen, device="cuda")
              * f ** -0.5).to(dt)
        for C in caps:
            buf = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
            dout = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
            fwd_tol = (2e-2 if dtype == "bfloat16" else 2e-5) * 5
            tol = 2e-2 if dtype == "bfloat16" else 1e-4
            err, rel, fwd_err, ref_out, ref_in = grads_against_plain(
                torch, MG.moe_gmm, moe_gmm_ref, (buf, w1, w3, w2), dout,
                ("dbuf", "dw1", "dw3", "dw2"), fwd_tol, tol,
                f"moe_gmm_bwd C={C} {dtype}")
            lib_in = [t.detach().requires_grad_(True) for t in
                      (buf, w1, w3, w2)]
            h = torch.nn.functional.silu(torch.bmm(lib_in[0], lib_in[1])) \
                * torch.bmm(lib_in[0], lib_in[2])
            lib_out = torch.bmm(h, lib_in[3])
            esz = buf.element_size()
            # inputs buf, dout, w1, w3, w2 read once; dbuf, dw1, dw3, dw2
            # written once; FLOPs / (E C d f): a and b recomputed (4), dh
            # (2), dw2 (2), dw1 and dw3 (4), dbuf (4)
            nbytes = (3 * E * C * d + 6 * E * d * f) * esz
            flops = 16 * E * C * d * f
            b_ms, b_by = bound(nbytes, 3 * flops, "tf32") \
                if dtype == "float32" else bound(nbytes, flops, dtype)
            row = {"phase": "moe_gmm_bwd", "arch": cfg.name, "E": E, "C": C,
                   "d": d, "f": f, "dtype": dtype,
                   "plan": [g._asdict() for g in MG.backward_plan(
                       E, C, d, f, dt, torch.cuda.get_device_properties(
                           0).multi_processor_count)],
                   "max_abs_err": err,
                   "max_err_over_max_ref": max(rel.values()),
                   "err_over_max_ref": rel, "tol_over_max_ref": tol,
                   "fwd_max_abs_err": fwd_err, "fwd_atol_rtol": fwd_tol,
                   "bitwise_repeatable": True,
                   "kernel_ms": time_ms(torch, lambda: MG.moe_gmm_bwd(
                       buf, w1, w3, w2, dout), 10),
                   "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                       ref_out, ref_in, dout.float(), retain_graph=True), 5),
                   "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                       lib_out, lib_in, dout, retain_graph=True), 10),
                   "bound_ms": b_ms, "bound_by": b_by}
            if dtype == "float32":
                row["bound_cuda_cores_ms"] = bound(nbytes, flops, dtype)[0]
            emit(row)
            rows.append(row)
            del buf, dout, ref_out, ref_in, lib_in, lib_out, h
        del w1, w3, w2
        torch.cuda.empty_cache()
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


def attn_case(c, S: int, dtype: str, window: int = 0, *, B: int = 1,
              T: int = 0, causal: bool = True, what: str = "") -> dict:
    """One attention row of :func:`phase_flash` / :func:`phase_flash_bwd`:
    ``c``'s heads, q (B, S), k/v (B, T or S); ``what`` names the path."""
    return dict(c=c, B=B, S=S, T=T or S, causal=causal, dtype=dtype,
                window=window, what=what)


def sdpa_mask(torch, S: int, T: int, causal: bool, window: int):
    """SDPA's ``(attn_mask, is_causal)`` for the kernel's masks (query and
    key positions both from 0, as SDPA's ``is_causal`` aligns them)."""
    if not window:
        return None, causal
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(T, device="cuda")[None, :]
    return (qp - kp < window) & ((qp >= kp) if causal else True), False


def phase_flash(torch, cases) -> list:
    """``cases``: :func:`attn_case` rows."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for a in cases:
        c, B, S, T, causal, dtype, window = (a[k] for k in (
            "c", "B", "S", "T", "causal", "dtype", "window"))
        H, KV, dh = c.n_heads, c.n_kv_heads, c.head_dim
        dt = getattr(torch, dtype)
        kw = dict(causal=causal, window=window)
        q = torch.randn(B, S, H, dh, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, T, KV, dh, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, KV, dh, generator=gen, device="cuda").to(dt)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        out = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(torch, out, attention_ref(q, k, v, **kw), tol, tol,
                      f"flash_attention {c.name} S={S} T={T} causal={causal} "
                      f"window={window} {dtype}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask, is_causal = sdpa_mask(torch, S, T, causal, window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=is_causal,
                enable_gqa=True)
        nbytes = (2 * B * S * H * dh + 2 * B * T * KV * dh) \
            * q.element_size()
        b_ms, b_by = bound(nbytes, attention_flops(
            S, T, B, H, dh, causal, window), dtype)
        row = {"phase": "flash_attention", "arch": c.name, "path": a["what"],
               "B": B, "S": S, "T": T, "H": H, "KV": KV, "dh": dh,
               "causal": causal, "window": window,
               "dtype": dtype, "max_abs_err": err, "atol": tol,
               "rtol": tol,
               "kernel_ms": time_ms(torch, lambda: FA.flash_attention(
                   q, k, v, **kw), 20),
               "plain_ms": time_ms(torch, lambda: attention_ref(
                   q, k, v, **kw), 5),
               "library_ms": time_ms(torch, library, 20),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
    return rows


def lse_ref(torch, q, k, causal: bool, window: int):
    """Each row's log-sum-exp of the scaled, masked scores, (B, H, S)
    fp32, from q (B, S, H, dh) and k (B, T, KV, dh) in fp32."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.float().reshape(
        B, S, KV, H // KV, dh), k.float()) * dh ** -0.5
    pos = torch.arange(S, device=q.device)[:, None]
    key = torch.arange(T, device=q.device)[None, :]
    mask = pos >= key if causal else torch.ones_like(pos >= key)
    if window:
        mask &= pos - key < window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def phase_flash_bwd(torch, cases) -> list:
    """The backward kernels of ``flash_attention`` (dq, dk, dv), and the
    forward kernel that runs in grad mode (its output and the row
    log-sum-exp it then writes), against the plain version; ``cases``:
    :func:`attn_case` rows."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    for a in cases:
        c, B, S, T, causal, dtype, window = (a[k] for k in (
            "c", "B", "S", "T", "causal", "dtype", "window"))
        H, KV, dh = c.n_heads, c.n_kv_heads, c.head_dim
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, dh, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(B, T, KV, dh, generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        dout = torch.randn(B, S, H, dh, generator=gen, device="cuda").to(dt)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        kw = dict(causal=causal, window=window)
        what = (f"flash_attention_bwd {c.name} S={S} T={T} causal={causal} "
                f"window={window} {dtype}")
        err, rel, fwd_err, ref_out, ref_in = grads_against_plain(
            torch, lambda *a: FA.flash_attention(*a, **kw),
            lambda *a: attention_ref(*a, **kw), (q, k, v), dout,
            ("dq", "dk", "dv"), tol, tol, what)
        out, lse = FA._forward(q, k, v, causal, window, with_lse=True)
        lse_err = max_err(torch, lse, lse_ref(torch, q, k, causal, window),
                          tol, tol, f"{what} lse")
        lib_in = [x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]
        mask, is_causal = sdpa_mask(torch, S, T, causal, window)

        def library(backward: bool):
            o = F.scaled_dot_product_attention(
                *lib_in, attn_mask=mask, is_causal=is_causal,
                enable_gqa=True)
            if backward:
                torch.autograd.grad(o, lib_in, dout.transpose(1, 2))
        # SDPA's backward: forward + backward less forward, in five
        # rounds (its single rounds spread by 2x between calls)
        lib_rounds = sorted(time_ms(torch, lambda: library(True), 10)
                            - time_ms(torch, lambda: library(False), 10)
                            for _ in range(5))
        lib_ms = lib_rounds[2]
        pairs = attention_flops(S, T, 1, 1, 1, causal, window) / 4
        # q, k, v, out, dout and lse read once; dq, dk, dv written once.
        # FLOPs: S = q k^T recomputed, dP = dO v^T, dv, dq and dk: 10·dh
        # per visible (query, key) pair per head
        nbytes = (4 * B * S * H * dh + 4 * B * T * KV * dh) \
            * q.element_size() + 4 * B * H * S
        b_ms, b_by = bound(nbytes, 10.0 * dh * B * H * pairs, dtype)
        row = {"phase": "flash_attention_bwd", "arch": c.name,
               "path": a["what"], "B": B, "S": S, "T": T, "H": H, "KV": KV,
               "dh": dh, "causal": causal,
               "window": window, "dtype": dtype, "max_abs_err": err,
               "max_err_over_max_ref": max(rel.values()),
               "err_over_max_ref": rel, "tol_over_max_ref": tol,
               "fwd_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
               "fwd_atol_rtol": tol, "bitwise_repeatable": True,
               "kernel_ms": time_ms(torch, lambda: FA.flash_attention_bwd(
                   q, k, v, out, lse, dout, **kw), 10),
               "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
                   ref_out, ref_in, dout.float(), retain_graph=True), 5),
               "library_ms": lib_ms, "library_rounds_ms": lib_rounds,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        del q, k, v, dout, ref_out, ref_in, out, lse, lib_in
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 4, 7, 9, 10 (fp32): forward vs prefill + decode or decode alone
# ---------------------------------------------------------------------------


def phase_fp32_forward(torch, cfg, prompt_len: int, via: str) -> dict:
    """Full width, fp32, TF32 off: ``forward(last_only)`` over a prompt
    (one ``ssm_scan`` launch per mamba layer at ssm_chunk 256) against
    the same prompt through ``prefill_step`` + one ``decode_step``
    (``via="prefill"``) or fed token by token through ``decode_step``
    (``via="decode"``: the recurrent, encdec and vlm families and
    sliding-window caches, which prefill refuses).  encdec and vlm read
    seeded frame or patch embeddings, and their decode a ``cross_kv``
    filled by :func:`fill_cross_kv`.  MoE capacity is ample (factor E /
    top_k), so no pair can drop: drops depend on how many tokens share a
    launch.  Each kernel must launch exactly as :func:`expected_launches`
    says, and every ``flash_attention`` launch of the forward is sorted by
    its masks and lengths: non-causal at S = T (the encoder), causal
    (self attention), non-causal at S != T (cross attention), each count
    exact (whisper-medium 24, 24, 24; the vlm cut 0, 8, 2)."""
    from repro_torch.device import parity_mode
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.models import model as TM
    from repro_torch.tree import tree_leaves

    parity_mode(deterministic=False)
    kw = {"moe_capacity_factor": cfg.n_experts / cfg.top_k} \
        if cfg.n_experts else {}
    c32 = dataclasses.replace(cfg, dtype="float32", **kw)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = TM.init_params(c32, gen, device="cuda")
    prompt = torch.randint(0, c32.vocab, (1, prompt_len), generator=gen,
                           device="cuda")
    batch = {"tokens": prompt, **ctx_input(torch, c32, 1, gen)}
    real, kinds = FA._forward, {"encoder": 0, "self": 0, "cross": 0}

    def spy(q, k, v, causal, window, with_lse):
        kinds["self" if causal else "encoder" if q.shape[1] == k.shape[1]
              else "cross"] += 1
        return real(q, k, v, causal, window, with_lse)

    FA._forward = spy
    try:
        MG.launches = FA.launches = SS.launches = 0
        fwd = TM.forward(params, c32, batch, ssm_chunk=256,
                         last_only=True)[:, 0]
        torch.cuda.synchronize()
        launches = {"flash_attention": FA.launches, "moe_gmm": MG.launches,
                    "ssm_scan": SS.launches}
    finally:
        FA._forward = real
    L = cfg.n_layers
    expect = {k: n for k, n in expected_launches(c32, prompt_len, 1).items()
              if k in launches}
    n_cross = {"encdec": L, "vlm": L // max(1, cfg.cross_every)}.get(
        cfg.family, 0)
    expect_kinds = {"encoder": cfg.enc_layers, "cross": n_cross,
                    "self": expect["flash_attention"] - cfg.enc_layers
                    - n_cross}
    t0 = time.perf_counter()
    if via == "prefill":
        cache = TM.init_cache(c32, 1, 2 * prompt_len, device="cuda")
        TM.prefill_step(params, c32, cache, {
            "tokens": prompt[:, :-1],
            "cache_index": torch.zeros(1, dtype=torch.long, device="cuda"),
            "count": torch.tensor([prompt_len - 1], device="cuda")})
        dec, _ = TM.decode_step(params, c32, cache, {
            "tokens": prompt[:, -1:], "cache_index": torch.tensor(
                [prompt_len - 1], device="cuda")})
    else:
        cache = TM.init_cache(c32, 1, prompt_len, device="cuda")
        if "cross_kv" in cache:
            fill_cross_kv(torch, params, c32, batch, cache)
        for t in range(prompt_len):
            dec, _ = TM.decode_step(params, c32, cache, {
                "tokens": prompt[:, t:t + 1],
                "cache_index": torch.tensor(t, device="cuda")})
    torch.cuda.synchronize()
    V = c32.vocab
    a_fwd = int(fwd[0, :V].argmax())
    a_dec = int(dec[0, :V].argmax())
    top2 = torch.topk(fwd[0, :V], 2).values
    row = {"phase": "fp32_forward", "arch": cfg.name, "dtype": "float32",
           "layers": L, "enc_layers": cfg.enc_layers,
           "d_model": cfg.d_model, "params": sum(
               t.numel() for t in tree_leaves(params)),
           "prompt": prompt_len, "via": via, "argmax_forward": a_fwd,
           "argmax_decode": a_dec,
           "logits_max_abs_diff": float((fwd - dec).abs().max()),
           "top2_margin": float(top2[0] - top2[1]),
           "decode_s": time.perf_counter() - t0, "launches": launches,
           "expected_launches": expect, "flash_launches_by_kind": kinds,
           "expected_by_kind": expect_kinds}
    emit(row)
    finite = bool(torch.isfinite(fwd).all()) and \
        bool(torch.isfinite(dec).all())
    del params, cache
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if a_fwd != a_dec:
        raise AssertionError(f"{cfg.name}: forward argmax != {via} argmax")
    if launches != expect or kinds != expect_kinds:
        raise AssertionError(f"{cfg.name}: launches {launches}, {kinds} != "
                             f"{expect}, {expect_kinds}")
    return row


def phase_chunked_prefill(torch) -> dict:
    """Dense qwen2.5 SMOKE, fp32 under deterministic algorithms: prefill
    in chunks of 11, 1 x 11 and 8 + 3 tokens gives bitwise the caches and
    logits of one whole prefill."""
    from repro_torch.configs import get_config
    from repro_torch.device import parity_mode
    from repro_torch.models import model as TM

    dense = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                                dtype="float32")
    parity_mode(deterministic=True)
    try:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        dp = TM.init_params(dense, gen, device="cuda")
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
    row = {"phase": "chunked_prefill", "arch": dense.name,
           "chunked_vs_whole_max_abs_diff": delta}
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
# Phase 6: ssm_scan
# ---------------------------------------------------------------------------


def phase_ssm_scan(torch) -> list:
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tol = 1e-4  # the reference's test_ssm_scan_sweep tolerance
    rows = []
    # falcon-mamba-7b's launch per 256-token chunk, from a zero and from a
    # carried state; a whole 2048-token layer; hymba-1.5b's ragged Di
    for what, B, L, Di, N, with_h0 in (
            ("falcon chunk", 1, 256, 8192, 16, False),
            ("falcon chunk, carried state", 1, 256, 8192, 16, True),
            ("falcon 2048-token layer", 1, 2048, 8192, 16, False),
            ("hymba chunk", 2, 256, 3200, 16, False)):
        dA = torch.rand(B, L, Di, N, generator=gen, device="cuda") * 0.5 + 0.5
        dBx = torch.randn(B, L, Di, N, generator=gen, device="cuda") * 0.1
        C = torch.randn(B, L, N, generator=gen, device="cuda")
        h0 = torch.randn(B, Di, N, generator=gen, device="cuda") \
            if with_h0 else None
        y, h = SS.ssm_scan(dA, dBx, C, h0)
        torch.cuda.synchronize()
        y_ref, h_ref = ssm_scan_ref(dA, dBx, C, h0)
        err = max(max_err(torch, y, y_ref, tol, tol, f"ssm_scan {what} y"),
                  max_err(torch, h, h_ref, tol, tol, f"ssm_scan {what} h"))
        # each input read once, y and the last state written once
        nbytes = 4 * (2 * B * L * Di * N + B * L * N + B * L * Di
                      + B * Di * N * (2 if with_h0 else 1))
        b_ms, b_by = bound(nbytes, 4.0 * B * L * Di * N, "float32")
        row = {"phase": "ssm_scan", "shape": what, "B": B, "L": L, "Di": Di,
               "N": N, "h0": with_h0, "dtype": "float32",
               "max_abs_err": err, "atol": tol, "rtol": tol,
               "kernel_ms": time_ms(torch, lambda: SS.ssm_scan(
                   dA, dBx, C, h0), 20),
               "plain_ms": time_ms(torch, lambda: ssm_scan_ref(
                   dA, dBx, C, h0), 2 if L > 256 else 3, warmup=1),
               # no single PyTorch call computes this recurrence
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        del dA, dBx, C, h0, y, h, y_ref, h_ref
    return rows


def phase_ssm_scan_bwd(torch) -> list:
    """The backward kernel of ``ssm_scan`` (d_dA, d_dBx, dC, dh0) against
    the plain backward ``ssm_scan_bwd_ref`` and against autograd through
    the plain scan, each output within 1e-5 × its largest reference value,
    two calls bitwise equal, at the main path's chunks: hymba-1.5b's (B 1,
    L 256, Di 3200) and falcon-mamba-7b's (Di 8192), from a zero state
    with no ``dh_last`` (a sequence's only chunk) and from a carried state
    with one (the middle chunks)."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tol = 1e-5
    names = ("d_dA", "d_dBx", "dC", "dh0")
    rows = []
    for what, B, L, Di, N, carried in (
            ("hymba chunk", 1, 256, 3200, 16, False),
            ("hymba chunk, carried state", 1, 256, 3200, 16, True),
            ("falcon chunk", 1, 256, 8192, 16, False),
            ("falcon chunk, carried state", 1, 256, 8192, 16, True)):
        dA = torch.rand(B, L, Di, N, generator=gen, device="cuda") * 0.5 + 0.5
        dBx = torch.randn(B, L, Di, N, generator=gen, device="cuda") * 0.1
        C = torch.randn(B, L, N, generator=gen, device="cuda")
        dy = torch.randn(B, L, Di, generator=gen, device="cuda")
        h0, dh = ((torch.randn(B, Di, N, generator=gen, device="cuda")
                   for _ in range(2)) if carried else (None, None))
        got = SS.ssm_scan_bwd(dA, dBx, C, h0, dy, dh)
        again = SS.ssm_scan_bwd(dA, dBx, C, h0, dy, dh)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"ssm_scan_bwd {what}: two calls differ")
        plain = ssm_scan_bwd_ref(dA, dBx, C, h0, dy, dh)
        leaves = [t.clone().requires_grad_(True) for t in (dA, dBx, C, h0)
                  if t is not None]
        y, h = ssm_scan_ref(*leaves)
        loss = (y * dy).sum() + ((h * dh).sum() if carried else 0.0)
        auto = torch.autograd.grad(loss, leaves)
        del y, h, loss, leaves
        rel, err = {}, 0.0
        for name, g, r, a in zip(names, got, plain, auto + (None,)):
            if g is None:
                continue
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"ssm_scan_bwd {what}: {name} "
                                     f"non-finite")
            for ref, against in ((r, "plain"), (a, "autograd")):
                if ref is None:
                    continue
                e, scale = float((g - ref).abs().max()), \
                    float(ref.abs().max())
                if e > tol * scale:
                    raise AssertionError(
                        f"ssm_scan_bwd {what}: {name} against {against} "
                        f"max |Δ| {e} beyond {tol} × {scale}")
                err = max(err, e)
                rel[f"{name} vs {against}"] = e / max(scale, 1e-30)
        # dA, dBx, C, dy (and h0, dh_last) read once; d_dA, d_dBx, dC
        # (and dh0) written once; ~10 FLOPs per state and step
        state = B * L * Di * N
        nbytes = 4 * (4 * state + 2 * B * L * N + B * L * Di
                      + (3 * B * Di * N if carried else 0))
        b_ms, b_by = bound(nbytes, 10.0 * state, "float32")
        row = {"phase": "ssm_scan_bwd", "shape": what, "B": B, "L": L,
               "Di": Di, "N": N, "h0_and_dh_last": carried,
               "plan": SS.bwd_plan(B, L, Di, N)._asdict(),
               "dtype": "float32", "max_abs_err": err,
               "err_over_max_ref": rel, "tol_over_max_ref": tol,
               "bitwise_repeatable": True,
               "kernel_ms": time_ms(torch, lambda: SS.ssm_scan_bwd(
                   dA, dBx, C, h0, dy, dh), 20),
               "plain_ms": time_ms(torch, lambda: ssm_scan_bwd_ref(
                   dA, dBx, C, h0, dy, dh), 2, warmup=1),
               # no single PyTorch call computes this recurrence
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        del dA, dBx, C, dy, h0, dh, got, again, plain, auto
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 8: falcon-mamba-7b in bf16, timed
# ---------------------------------------------------------------------------


def phase_ssm_bf16(torch, cfg, card: str) -> dict:
    """One 2048-token forward and 32 greedy decode steps after a 16-token
    prompt, host clock around synchronised work."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.models import model as TM

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = TM.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                         device="cuda")
    TM.forward(params, cfg, {"tokens": toks}, last_only=True)  # warm-up
    torch.cuda.synchronize()
    SS.launches = 0
    t0 = time.perf_counter()
    fwd = TM.forward(params, cfg, {"tokens": toks}, last_only=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = SS.launches
    cache = TM.init_cache(cfg, 1, 64, device="cuda")
    for t in range(16):
        logits, _ = TM.decode_step(params, cfg, cache, {
            "tokens": toks[:, t:t + 1],
            "cache_index": torch.tensor(t, device="cuda")})
    nxt = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
    finite = bool(torch.isfinite(fwd).all()) and \
        bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(16, 48):
        logits, _ = TM.decode_step(params, cfg, cache, {
            "tokens": nxt, "cache_index": torch.tensor(t, device="cuda")})
        nxt = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
        finite = finite and bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / 32
    row = {"phase": "ssm_bf16", "arch": cfg.name, "dtype": cfg.dtype,
           "card": card, "forward_tokens": 2048, "forward_ms": fwd_ms,
           "forward_tokens_per_s": 2048 / fwd_ms * 1e3,
           "forward_ssm_scan_launches": fwd_launches,
           "decode_steps": 32, "decode_ms_per_token": dec_ms,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "finite": finite}
    emit(row)
    del params, cache
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("ssm_bf16: non-finite logits")
    if fwd_launches != cfg.n_layers * 2048 // 256:
        raise AssertionError(f"ssm_bf16: {fwd_launches} ssm_scan launches")
    return row


# ---------------------------------------------------------------------------
# Phases 9-10 (bf16): phi3-mini-3.8b and mixtral-8x7b (2 layers), timed
# ---------------------------------------------------------------------------


def phase_wide_bf16(torch, cfg, card: str, prompt_len: int) -> dict:
    """bf16: one warm-up and one timed ``forward(last_only)`` over a
    prompt (vlm: and seeded patch embeddings), host clock around
    synchronised work; exactly one ``flash_attention`` (and, for MoE, one
    ``moe_gmm``) launch per layer."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.models import model as TM

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = TM.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, prompt_len), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, **ctx_input(torch, cfg, 1, gen)}
    TM.forward(params, cfg, batch, last_only=True)  # warm-up
    torch.cuda.synchronize()
    MG.launches = FA.launches = 0
    t0 = time.perf_counter()
    fwd = TM.forward(params, cfg, batch, last_only=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": FA.launches, "moe_gmm": MG.launches}
    expect = {"flash_attention": expected_launches(
        cfg, prompt_len, 1)["flash_attention"],
              "moe_gmm": cfg.n_layers if cfg.n_experts else 0}
    finite = bool(torch.isfinite(fwd).all())
    row = {"phase": "wide_bf16", "arch": cfg.name, "dtype": cfg.dtype,
           "card": card, "layers": cfg.n_layers, "window":
               cfg.sliding_window, "forward_tokens": prompt_len,
           "forward_ms": fwd_ms,
           "forward_tokens_per_s": prompt_len / fwd_ms * 1e3,
           "launches": launches, "expected_launches": expect,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9, "finite": finite}
    emit(row)
    del params, fwd
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError(f"{cfg.name} bf16: non-finite logits")
    if launches != expect:
        raise AssertionError(f"{cfg.name} bf16: launches {launches} != "
                             f"{expect}")
    return row


# ---------------------------------------------------------------------------
# Phases 11-13: training
# ---------------------------------------------------------------------------


def train_setup(torch, cfg, seed: int = SEED, seq_len: int = 1024,
                global_batch: int = 8, microbatches: int = 2):
    """The training step of phase 13, which
    ``benchmarks/torch_train_profile.py`` profiles: ``cfg`` on the card
    with random weights from ``seed``, ``init_opt_state`` and
    ``build_train_step`` (``seq_len`` tokens, ``global_batch`` sequences
    in ``microbatches``, policy ``afe``, sched policy ``dlbc``, AdamW at lr
    1e-4 with warmup 1) and one fixed batch (with seeded frame or patch
    embeddings for encdec and vlm).  Returns (step, params, opt, batch,
    shape)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as TM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, build_train_step

    shape = ShapeConfig("train", seq_len, global_batch, "train",
                        microbatches=microbatches)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = TM.init_params(cfg, gen, device="cuda")
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=1)
    opt = init_opt_state(params, ocfg)
    step, _ = build_train_step(cfg, shape, StepConfig(
        policy="afe", sched_policy="dlbc"), ocfg)
    toks = torch.randint(0, cfg.vocab, (shape.global_batch,
                                        shape.seq_len + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             **ctx_input(torch, cfg, shape.global_batch, gen)}
    return step, params, opt, batch, shape


def kernel_counters():
    """The wrappers' launch counters, by kernel name: (module, attribute)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.ssm_scan import ssm_scan as SS

    return {"flash_attention": (FA, "launches"),
            "flash_attention_bwd": (FA, "bwd_launches"),
            "moe_gmm": (MG, "launches"), "moe_gmm_bwd": (MG, "bwd_launches"),
            "ssm_scan": (SS, "launches"), "ssm_scan_bwd": (SS, "bwd_launches")}


def read_counters() -> dict:
    return {k: getattr(m, a) for k, (m, a) in kernel_counters().items()}


def zero_counters() -> None:
    for m, a in kernel_counters().values():
        setattr(m, a, 0)


def expected_launches(cfg, seq_len: int, microbatches: int,
                      ssm_chunk: int = 256) -> dict:
    """Each kernel's launches in one forward + backward per microbatch:
    one per attention layer (encdec: each encoder layer, and each decoder
    layer twice, self and cross; vlm: each self and each cross layer),
    one per MoE layer, one per mamba layer and ``ssm_chunk`` tokens; each
    backward kernel as often as its forward."""
    L = cfg.n_layers
    attn = {"ssm": 0, "encdec": cfg.enc_layers + 2 * L}.get(cfg.family, L)
    per = {"flash_attention": attn,
           "moe_gmm": L if cfg.n_experts else 0,
           "ssm_scan": L * max(1, seq_len // ssm_chunk)
           if cfg.family in ("ssm", "hybrid") else 0}
    out = {}
    for k, n in per.items():
        out[k] = out[k + "_bwd"] = n * microbatches
    return out


def phase_train_grads(torch, cfg, S: int = 256, ssm_chunk: int = 256
                      ) -> dict:
    """``cfg`` at full width, 2 layers (encdec: 2 + 2), fp32 (TF32 off),
    B 2 x ``S`` tokens (encdec: and 2 x 1500 seeded frames; their
    gradients cross from the decoder's cross attention into the
    encoder): one ``loss_fn`` backward on the card (the kernels and their
    backward kernels; mamba layers in ``S / ssm_chunk`` chained chunks)
    against the same weights' gradients on the CPU (the plain versions).
    For MoE the expert ids and keep masks of both runs are compared first
    (a route that flips on a near-tie is reported as such); then every
    parameter's gradient must be within 1e-4 of its largest CPU gradient
    (the ``moe_gmm`` fp32 tolerance)."""
    from repro_torch.device import parity_mode
    from repro_torch.models import model as TM
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_leaves, tree_map

    parity_mode(deterministic=False)
    c = dataclasses.replace(cfg, dtype="float32", n_layers=2, **(
        {"enc_layers": 2} if cfg.family == "encdec" else {}))
    p_cpu = TM.init_params(c, torch.Generator().manual_seed(SEED),
                           device="cpu")
    toks = torch.randint(0, c.vocab, (2, S + 1),
                         generator=torch.Generator().manual_seed(SEED))
    ctx = ctx_input(torch, c, 2, torch.Generator().manual_seed(SEED + 1),
                    device="cpu")
    routes, grads, launches = {"cpu": [], "cuda": []}, {}, {}
    real = M.dispatch_combine

    def spy(x, gates, ids, pos, keep, *a, **k):
        routes[x.device.type].append((ids.cpu(), keep.cpu()))
        return real(x, gates, ids, pos, keep, *a, **k)

    M.dispatch_combine = spy
    try:
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().to(dev).clone()
                         .requires_grad_(True), p_cpu)
            batch = {"tokens": toks[:, :-1].to(dev),
                     "labels": toks[:, 1:].to(dev),
                     **{k: v.to(dev) for k, v in ctx.items()}}
            zero_counters()
            TM.loss_fn(p, c, batch, ssm_chunk=ssm_chunk).backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counters()
            grads[dev] = [t.grad.cpu() for t in tree_leaves(p)]
            del p
    finally:
        M.dispatch_combine = real
    flips = sum(int(not (torch.equal(ic, ig) and torch.equal(kc, kg)))
                for (ic, kc), (ig, kg) in zip(routes["cpu"], routes["cuda"]))
    worst = 0.0
    for gc, gg in zip(grads["cpu"], grads["cuda"]):
        if not bool(torch.isfinite(gg).all()):
            raise AssertionError("train_grads: non-finite card gradient")
        worst = max(worst, float((gg - gc).abs().max())
                    / max(float(gc.abs().max()), 1e-30))
    expect = expected_launches(c, S, 1, ssm_chunk)
    row = {"phase": "train_grads", "arch": cfg.name, "dtype": "float32",
           "layers": 2, "enc_layers": c.enc_layers, "d_model": c.d_model,
           "B": 2, "S": S,
           "ssm_chunk": ssm_chunk,
           "params": sum(t.numel() for t in tree_leaves(p_cpu)),
           "leaves": len(grads["cpu"]), "routed_layers": len(routes["cuda"]),
           "route_flips": flips, "max_err_over_max_cpu_grad": worst,
           "tol": 1e-4, "launches": launches, "expected_launches": expect}
    emit(row)
    if flips:
        raise AssertionError(f"train_grads: {flips} layer(s) routed a token "
                             f"differently on the card (near-tie)")
    if worst > 1e-4:
        raise AssertionError(f"train_grads: gradient error {worst} > 1e-4")
    if launches != expect:
        raise AssertionError(f"train_grads: launches {launches}")
    return row


def phase_train(torch, cfg, card: str, steps: int = 4, seq_len: int = 1024,
                global_batch: int = 8, microbatches: int = 2) -> dict:
    """``cfg`` at full width (bf16): the step of :func:`train_setup`
    (``build_train_step`` + ``init_opt_state``, policy ``afe``, sched
    policy ``dlbc``); ``steps`` AdamW steps (lr 1e-4, warmup 1) on one
    fixed batch.  Every step must launch each kernel and each backward
    kernel exactly as :func:`expected_launches` says (granite: 24 × 2 of
    ``flash_attention`` and ``moe_gmm``; hymba-1.5b: 32 × 8 of
    ``flash_attention`` and 32 × 4 chunks × 8 of ``ssm_scan``); losses
    finite and falling."""
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    step, params, opt, batch, shape = train_setup(
        torch, cfg, seq_len=seq_len, global_batch=global_batch,
        microbatches=microbatches)
    S, B, Mb = shape.seq_len, shape.global_batch, shape.microbatches
    expect = expected_launches(cfg, S, Mb)
    losses, norms, skipped, step_ms, per_step = [], [], [], [], []
    torch.cuda.synchronize()
    zero_counters()
    for _ in range(steps):
        before = read_counters()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_counters()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        skipped.append(int(m["nonfinite_skipped"]))
    launches = read_counters()
    rest = sum(step_ms[1:]) / max(1, len(step_ms) - 1)
    n_params = sum(t.numel() for t in tree_leaves(params))
    row = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "card": card, "layers": cfg.n_layers, "params": n_params,
           "seq_len": S, "global_batch": B, "microbatches": Mb,
           "policy": "afe", "sched_policy": "dlbc", "steps": steps,
           "losses": losses, "grad_norms": norms,
           "nonfinite_skipped": sum(skipped), "step_ms": step_ms,
           "first_step_ms": step_ms[0], "rest_step_ms": rest,
           "tokens_per_s": B * S / rest * 1e3,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step,
           "expected_launches_per_step": expect, "launches": launches}
    emit(row)
    del params, opt, m
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("train: non-finite loss or gradient norm")
    if sum(skipped) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}, skipped {skipped}")
    if any(p != expect for p in per_step):
        raise AssertionError(f"train: launches per step {per_step}, "
                             f"expected {expect}")
    return row


def phase_train_cli(torch, arch: str) -> dict:
    """``repro_torch.launch.train`` as a user runs it (on the card): 8
    smoke steps with checkpoints every 2 and a crash injected after step
    5, the same run again (it resumes from step 4), and an uninterrupted
    run; the resumed run's final loss within 1e-5 of the uninterrupted
    one.  Checkpoints go under ``build/`` and are removed."""
    import shutil

    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import SimulatedFailure

    from repro_torch.device import parity_mode

    base = ROOT / "build" / "chip_smoke_train_cli"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--arch", arch, "--smoke", "--steps", "8", "--ckpt-every",
              "2"]
    # deterministic algorithms: the embedding gradient's scatter-add would
    # otherwise sum in an order that changes from run to run, which is
    # not what this phase checks (restore + data replay)
    parity_mode(deterministic=True)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                launch_train.main(common + ["--ckpt-dir", str(base / "a"),
                                            "--failure-at", "5"])
                crashed = False
            except SimulatedFailure:
                crashed = True
            resumed = launch_train.main(common + ["--ckpt-dir",
                                                  str(base / "a")])
            whole = launch_train.main(common + ["--ckpt-dir",
                                                str(base / "b")])
        wall = time.perf_counter() - t0
    finally:
        parity_mode(deterministic=False)
        shutil.rmtree(base, ignore_errors=True)
    diff = abs(resumed["last_loss"] - whole["last_loss"])
    row = {"phase": "train_cli", "arch": resumed["arch"],
           "crashed_at_5": crashed, "resumed_from": resumed["resumed_from"],
           "completed": resumed["completed"],
           "first_loss": whole["first_loss"],
           "last_loss_resumed": resumed["last_loss"],
           "last_loss_uninterrupted": whole["last_loss"],
           "last_loss_abs_diff": diff, "mean_step_s": whole["mean_step_s"],
           "wall_s": wall}
    emit(row)
    if not crashed or resumed["resumed_from"] != 4 or \
            resumed["completed"] != 8 or diff > 1e-5:
        raise AssertionError(f"train_cli: {row}")
    return row


# ---------------------------------------------------------------------------
# Phases 15-16: the encoder-decoder and vision-language families
# ---------------------------------------------------------------------------


def ctx_input(torch, cfg, B: int, gen, device="cuda") -> dict:
    """What the stubbed frontends give the encdec and vlm families: seeded
    frame (``enc_frames``, B x enc_seq) or patch (``vis_embed``, B x
    vis_seq) embeddings of width d_model in ``cfg``'s dtype; {} for the
    other families."""
    from repro_torch.device import torch_dtype

    if cfg.family not in ("encdec", "vlm"):
        return {}
    key, n = ("enc_frames", cfg.enc_seq) if cfg.family == "encdec" \
        else ("vis_embed", cfg.vis_seq)
    return {key: torch.randn(B, n, cfg.d_model, generator=gen,
                             device=device).to(torch_dtype(cfg.dtype))}


def fill_cross_kv(torch, params, cfg, batch: dict, cache: dict) -> None:
    """Write ``cache["cross_kv"]`` for ``batch``: the cross layers' K/V over
    the encoder output (encdec: the non-causal encoder stack, then
    ``enc_norm``) or the patch embeddings (vlm), through each cross
    layer's own ``wk`` / ``wv``.  Harness code: the package, like the
    reference, leaves filling ``cross_kv`` to its caller."""
    from repro_torch.models import blocks as TB
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM

    with torch.no_grad():
        if cfg.family == "encdec":
            ctx = batch["enc_frames"].to(params["embed"].dtype)
            for p in TM._unbind(params["enc_layers"]):
                ctx = TB.layer_apply(p, cfg, ctx, "enc", causal=False)
            ctx = TL.norm_apply(params["enc_norm"], ctx, cfg.norm)
            attn = params["dec_layers"]["cross"]
        else:
            ctx = batch["vis_embed"].to(params["embed"].dtype)
            attn = params["cross_layers"]["attn"]
        B, T = ctx.shape[:2]
        for i in range(TM._n_layers(attn)):
            for name, w in (("k", "wk"), ("v", "wv")):
                cache["cross_kv"][name][i].copy_(TL.dense_apply(
                    TM._layer(attn[w], i), ctx).reshape(
                        B, T, cfg.n_kv_heads, cfg.head_dim))


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
    falcon, hymba = get_config("falcon-mamba-7b"), get_config("hymba-1.5b")
    phi3 = get_config("phi3-mini-3.8b")
    # mixtral-8x7b's 46.7 B parameters (93 GB in bf16) exceed the card's
    # 80 GB: 2 of its 32 layers at published widths, the one reduction
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2)
    # granite: C = 8, a decode step of 8 slots; C = 80, a prefill round of
    # 8 x 32 tokens; C = 256, the 256-token forward of phase 4; C = 1280,
    # a training microbatch of 4 x 1024 tokens (phase 13)
    moe_rows = timed(phase_moe_gmm, torch, cfg,
                     (("bfloat16", (8, 80, 256, 1280)),
                      ("float32", (8, 80, 256))))
    # granite: S = 256 fp32 causal is the forward of phase 4, S = 2048 a
    # long prompt; hymba (G = 5, window 1024): S = 256 fp32 is the forward
    # of phase 7; phi3-mini (dh 96, G = 1) and mixtral (window 4096): the
    # forwards of phases 9 and 10
    hw = hymba.sliding_window
    A = attn_case
    flash_rows = timed(phase_flash, torch, (
        A(cfg, 256, "float32"), A(cfg, 2048, "bfloat16"),
        A(cfg, 2048, "bfloat16", 256), A(cfg, 2048, "float32"),
        A(cfg, 2048, "float32", 256), A(hymba, 256, "float32", hw),
        A(hymba, 2048, "bfloat16", hw), A(phi3, 256, "float32"),
        A(phi3, 2048, "bfloat16"),
        A(mixtral, 512, "bfloat16", mixtral.sliding_window)))
    timed(phase_fp32_forward, torch, cfg, 256, "prefill")
    timed(phase_chunked_prefill, torch)
    srv = timed(phase_serve, torch, cfg, smi)
    ssm_rows = timed(phase_ssm_scan, torch)
    ssm_fwd = timed(phase_fp32_forward, torch, falcon, 256, "decode")
    timed(phase_fp32_forward, torch, hymba, 256, "decode")
    timed(phase_ssm_bf16, torch, falcon, smi)
    timed(phase_fp32_forward, torch, phi3, 256, "prefill")
    phi3_bf16 = timed(phase_wide_bf16, torch, phi3, smi, 2048)
    # mixtral's experts at the capacities of phase 10's runs: C = 8 for a
    # decode step, C = 160 for 512 bf16 tokens (factor 1.25), C = 64 for
    # 64 fp32 tokens (E/k)
    timed(phase_moe_gmm, torch, mixtral,
          (("bfloat16", (8, 160)), ("float32", (64,))))
    timed(phase_fp32_forward, torch, mixtral, 64, "decode")
    timed(phase_wide_bf16, torch, mixtral, smi, 512)
    # training (phases 11-13): the backward kernels at granite's training
    # shapes (B 4 x S 1024 per microbatch: C = 1280), a windowed shape and
    # phi3's head dim 96; full-width gradients against the CPU; AdamW
    # steps at full width; the training CLI with a crash and a resume
    fa_bwd_rows = timed(phase_flash_bwd, torch, (
        A(cfg, 1024, "bfloat16", B=4), A(cfg, 1024, "float32", B=4),
        A(cfg, 1024, "bfloat16", 256, B=4), A(phi3, 2048, "bfloat16"),
        A(hymba, 1024, "bfloat16", hw)))
    moe_bwd_rows = timed(phase_moe_gmm_bwd, torch, cfg, (
        ("bfloat16", (1280, 8)), ("float32", (1280,))))
    ssm_bwd_rows = timed(phase_ssm_scan_bwd, torch)
    timed(phase_train_grads, torch, cfg)
    train = timed(phase_train, torch, cfg, smi)
    timed(phase_train_cli, torch, cfg.name)
    # hymba-1.5b: 2-layer fp32 gradients in two chained scan chunks, then
    # full-width bf16 AdamW steps, seq 1024, 8 microbatches of 1 sequence
    timed(phase_train_grads, torch, hymba, 256, 128)
    hymba_train = timed(phase_train, torch, hymba, smi, 4, 1024, 8, 8)
    # the encoder-decoder and vision-language families (phases 15-16):
    # flash_attention at their shapes — whisper's encoder (S = T = 1500,
    # non-causal), its cross attention (448 decoder positions, Whisper's
    # context, against 1500 frames) and decoder self attention at a
    # training microbatch of 4, the vlm's cross attention (512 tokens
    # against 1601 patches, G 8, dh 128); whisper-medium at full width
    # and depth (fp32 forward vs decode, 2 + 2-layer gradients, four bf16
    # AdamW steps at seq 448); llama-3.2-vision-90b at full width, 10 of
    # its 100 layers (two groups of four self layers and a cross layer:
    # its ~180 GB of bf16 weights exceed the card), fp32 forward vs
    # decode and a bf16 512-token forward
    whisper = get_config("whisper-medium")
    vlm = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                              n_layers=10)
    E, V = whisper.enc_seq, vlm.vis_seq
    timed(phase_flash, torch, (
        A(whisper, E, "bfloat16", causal=False, what="whisper encoder"),
        A(whisper, E, "bfloat16", B=4, causal=False,
          what="whisper encoder, training microbatch"),
        A(whisper, 448, "bfloat16", B=4, T=E, causal=False,
          what="whisper cross"),
        A(whisper, 448, "float32", B=4, T=E, causal=False,
          what="whisper cross"),
        A(whisper, 448, "bfloat16", B=4, what="whisper decoder self"),
        A(vlm, 512, "bfloat16", T=V, causal=False, what="vlm cross")))
    xattn_bwd_rows = timed(phase_flash_bwd, torch, (
        A(whisper, 448, "bfloat16", B=4, T=E, causal=False,
          what="whisper cross, training microbatch"),
        A(whisper, 448, "float32", B=4, T=E, causal=False,
          what="whisper cross"),
        A(whisper, E, "bfloat16", B=4, causal=False,
          what="whisper encoder, training microbatch"),
        A(whisper, 448, "bfloat16", B=4,
          what="whisper decoder self, training microbatch"),
        A(vlm, 512, "bfloat16", T=V, causal=False, what="vlm cross")))
    timed(phase_fp32_forward, torch, whisper, 64, "decode")
    timed(phase_train_grads, torch, whisper, 64)
    whisper_train = timed(phase_train, torch, whisper, smi, 4, 448, 8, 2)
    timed(phase_fp32_forward, torch, vlm, 64, "decode")
    timed(phase_wide_bf16, torch, vlm, smi, 512)

    moe_main = next(r for r in moe_rows
                    if r["C"] == 8 and r["dtype"] == "bfloat16")
    flash_main = next(r for r in flash_rows
                      if r["arch"] == phi3.name and r["S"] == 2048)
    ssm_main = ssm_rows[0]
    fa_bwd_main, moe_bwd_main = fa_bwd_rows[0], moe_bwd_rows[0]
    xattn_bwd_main = xattn_bwd_rows[0]
    ssm_bwd_main = ssm_bwd_rows[1]
    kernels = [
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_dispatch/moe_gmm.py:62",
         "launches": srv["cli_launches"]["moe_gmm"],
         "shape": "E=32 C=8 d=1024 f=512 bf16 (decode step)",
         "max_abs_err": moe_main["max_abs_err"], "ms": moe_main["kernel_ms"],
         "plain_ms": moe_main["plain_ms"], "bound_ms": moe_main["bound_ms"],
         "bound_by": moe_main["bound_by"],
         "library_ms": moe_main["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:127",
         "launches": phi3_bf16["launches"]["flash_attention"],
         "shape": "B=1 S=2048 H=32 KV=32 dh=96 causal bf16 (phi3-mini-3.8b "
                  "forward, one launch per layer, tensor cores)",
         "max_abs_err": flash_main["max_abs_err"],
         "ms": flash_main["kernel_ms"], "plain_ms": flash_main["plain_ms"],
         "bound_ms": flash_main["bound_ms"],
         "bound_by": flash_main["bound_by"],
         "library_ms": flash_main["library_ms"]},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:72",
         "launches": ssm_fwd["launches"]["ssm_scan"],
         "shape": "B=1 L=256 Di=8192 N=16 fp32 (falcon-mamba-7b forward, "
                  "one launch per layer)",
         "max_abs_err": ssm_main["max_abs_err"], "ms": ssm_main["kernel_ms"],
         "plain_ms": ssm_main["plain_ms"], "bound_ms": ssm_main["bound_ms"],
         "bound_by": ssm_main["bound_by"], "library_ms": None},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:127",
         "launches": train["launches"]["flash_attention_bwd"],
         "shape": "B=4 S=1024 H=16 KV=8 dh=64 causal bf16 (granite-moe-1b-"
                  "a400m training microbatch, one launch per layer)",
         "max_abs_err": fa_bwd_main["max_abs_err"],
         "ms": fa_bwd_main["kernel_ms"], "plain_ms": fa_bwd_main["plain_ms"],
         "bound_ms": fa_bwd_main["bound_ms"],
         "bound_by": fa_bwd_main["bound_by"],
         "library_ms": fa_bwd_main["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:127",
         "launches": whisper_train["launches"]["flash_attention_bwd"],
         "shape": "B=4 S=448 T=1500 H=16 KV=16 dh=64 non-causal bf16 "
                  "(whisper-medium training microbatch, cross attention; 72 "
                  "launches per microbatch: 24 encoder, 24 decoder self, 24 "
                  "cross)",
         "max_abs_err": xattn_bwd_main["max_abs_err"],
         "ms": xattn_bwd_main["kernel_ms"],
         "plain_ms": xattn_bwd_main["plain_ms"],
         "bound_ms": xattn_bwd_main["bound_ms"],
         "bound_by": xattn_bwd_main["bound_by"],
         "library_ms": xattn_bwd_main["library_ms"]},
        {"name": "moe_gmm_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_dispatch/moe_gmm.py:62",
         "launches": train["launches"]["moe_gmm_bwd"],
         "shape": "E=32 C=1280 d=1024 f=512 bf16 (granite-moe-1b-a400m "
                  "training microbatch, one launch per layer)",
         "max_abs_err": moe_bwd_main["max_abs_err"],
         "ms": moe_bwd_main["kernel_ms"], "plain_ms": moe_bwd_main["plain_ms"],
         "bound_ms": moe_bwd_main["bound_ms"],
         "bound_by": moe_bwd_main["bound_by"],
         "library_ms": moe_bwd_main["library_ms"]},
        {"name": "ssm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:72",
         "launches": hymba_train["launches"]["ssm_scan_bwd"],
         "shape": "B=1 L=256 Di=3200 N=16 fp32, carried state (hymba-1.5b "
                  "training, one launch per layer and 256-token chunk)",
         "max_abs_err": ssm_bwd_main["max_abs_err"],
         "ms": ssm_bwd_main["kernel_ms"], "plain_ms": ssm_bwd_main["plain_ms"],
         "bound_ms": ssm_bwd_main["bound_ms"],
         "bound_by": ssm_bwd_main["bound_by"], "library_ms": None},
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
