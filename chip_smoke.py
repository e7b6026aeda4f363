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
   prefill round, C=256 per 256-token forward, C=1024 per EP round),
   bf16 and fp32, and at a training microbatch's C=1280 in bf16, with each
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
    on one batch (lr 1e-4, warmup 1), first without ``remat``, then with
    it (the default: every layer checkpointed and recomputed in the
    backward): finite, falling losses, no skipped step, step time,
    tokens/s, peak memory, and exactly 24 × 2 launches of each backward
    kernel per step and of each forward kernel without ``remat``, 24 × 2
    × 2 with it; ``train_cli``:
    ``repro_torch.launch.train`` (8 smoke steps, checkpoints every 2, a
    crash after step 5, then the same run resumes from step 4) against an
    uninterrupted run, final losses within 1e-5.
14. hymba-1.5b training: ``train_grads`` at full width, 2 layers, fp32,
    the scan in two chained 128-token chunks; ``train`` at full width and
    8 of its 32 layers (bf16; the depth cut keeps the whole script well
    inside its time limit), seq 1024, global batch 8 in 8
    microbatches, four AdamW steps without ``remat`` and four with it,
    with exactly 8 × 8 launches of ``flash_attention_bwd`` and 8 × 4 × 8
    of ``ssm_scan_bwd`` per step, and of the forwards 1× / 2× (attention)
    and 2× / 3× (the scan) that; ``train_fit``: the same step at all 32
    layers in 4 microbatches of 2 sequences, or a row saying it does not
    fit.
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
    microbatches, without ``remat`` and with it, 72 launches of
    ``flash_attention_bwd`` per microbatch (and of ``flash_attention``
    72 / 144).
16. llama-3.2-vision-90b (10 layers): ``fp32_forward`` over 64 tokens
    and seeded patch embeddings against decode (8 causal self and 2
    cross launches), and ``wide_bf16``, a timed 512-token forward with
    10 ``flash_attention`` launches.
17. ``dist_policies`` (after phase 13): a one-rank NCCL process group and
    a ``make_test_mesh(data=1, model=1)`` mesh; granite at full width and
    4 of its 24 layers takes two AdamW steps under each policy (``unopt``,
    ``lc``, ``afe``,
    ``afe_bucket``; seq 1024, batch 8 in 2 microbatches) on the mesh and
    without it, under deterministic algorithms: params bitwise equal,
    each step's collective counts those derived from the param tree and
    the bucket plan.
18. ``ep_round``: the expert-parallel round on a one-rank expert axis at
    granite's full MoE width (E 32, top-8, d 1024, f 512), 1024 tokens,
    capacity factor E / top_k, fp32 and bf16: equal to the single-host
    ``moe_apply`` (fp32 1e-5, bf16 the ``moe_gmm`` tolerance), one join
    per round, one ``moe_gmm`` launch per round, the round's and
    ``moe_apply``'s times.
19. ``tp_train``: tensor parallelism on a ``(data 1, model 2)`` mesh,
    two processes on the one card over gloo, policy ``lc``; first each
    kernel and backward kernel at one model rank's shapes (granite's H8
    KV4 attention and E16 C1280 experts, hymba's Di 1600 scan); then fp32
    2-layer steps (granite with E over the model axis, a granite copy
    with E 3 whose d_ff goes over it, hymba-1.5b with its 25 heads whole
    on both ranks) against the one-process step, each rank's shards of
    the params after the step and of its first moment within 1e-4; and
    two full-width bf16 granite steps (seq 1024, batch 8 in 2
    microbatches) within 2e-2 of the one-process steps, per-rank launches
    exactly ``expected_launches`` of the rank-local config, per-rank peak
    and activation memory.  The model axis is
    sequence-parallel (2 divides S): granite's model-axis collectives
    are exactly ``tp_expected``'s (all-gathers, reduce-scatters and
    all-reduces).
20. ``ep_train``: expert parallelism under autograd.  (a) On a one-rank
    NCCL group, the EP round (``ep_dispatch_combine`` over an expert-axis
    ``Collectives``) forward and backward at granite's full MoE width on
    a training microbatch's 4096 tokens (C 1280), fp32 and bf16, against
    ``moe_apply``'s output and gradients (x, router, w1, w3, w2; 1e-4 /
    0.1 of each one's largest value), exactly one ``moe_gmm`` and one
    ``moe_gmm_bwd`` launch and two all-to-alls and one all-gather each
    way per round, with both forward + backward times.  (b) Two
    processes on the one card over gloo on an ``(expert 2, data 1,
    model 1)`` mesh, bf16 granite at full width and 4 of its 24 layers
    (phase 22 runs the expert axis at full depth) with
    ``expert_parallel`` (E 16 per rank), ``lc`` and ``afe`` for 2 steps
    at C 1280 and one
    ``lc`` step at capacity factor 4: losses within 2e-2 of the
    one-process steps (and, at ample capacity, gradient norms), launches
    and both axes' collectives exact, per-rank step ms and peak memory.
    (c) Four such processes on ``(expert 2, data 2, model 1)``, 2 ``lc``
    steps: the EP round over both data ranks' rows (fault N's repair),
    the same gates, and on the data axis one all-gather of the token
    rows per MoE layer and forward beside ``lc``'s all-reduces.

21. ``tp_serve``: tensor-parallel serving.  ``moe_gmm`` at one model
    rank of 2's serving shapes (E 16, C 8 and C 80, bf16) against its
    plain version and the ``torch.bmm`` chain; (a) on a one-rank NCCL
    group, granite at full width (bf16) serves phase 5's closed batch on
    a ``(data 1, model 1)`` mesh: the tokens bitwise equal to phase 5's
    mesh-free run, each axis's collectives exact; (b) two processes on
    the one card over gloo at ``(data 1, model 2)``: fp32 teacher-forced
    decode of full-width granite and hymba-1.5b, 16 steps, each step's
    logits gathered over the vocab shards within 1e-4 of the one-process
    port's, and fp32 chunked prefill (granite, 2 layers) equal to whole
    prefill on each rank (max |Δ| 0.0);
    (c) the two ranks serve the closed batch in bf16 (E 16 per rank):
    16/16 finished, both ranks' tokens identical, ``moe_gmm`` exactly 24
    launches per model launch and the collectives exact; step p50 / p99,
    tokens/s, peak memory per rank against phase 5's one process, and the
    share of tokens equal to phase 5's.
22. ``ep_tp``: EP with a model axis, the reference's ``(expert, data,
    model)`` production layout.  (a) ``moe_gmm`` at one rank of
    ``(expert 2, model 2)``'s shapes (E 16, d 1024, f 256: C 8, C 80 and
    a training microbatch's round's C 1280, bf16) and ``moe_gmm_bwd`` at
    C 1280, against their plain versions and the ``torch.bmm`` chain;
    then four processes on the one card over gloo at ``(expert 2, data 1,
    model 2)``, full-width granite with ``expert_parallel`` (each rank 16
    experts × 256 d_ff columns, 8 heads, half the vocab; the EP round
    inside the tensor-parallel region): (d) fp32, 2 layers, capacity
    factor E / top_k, 16 teacher-forced decode steps and chunked and
    whole prefill within 2e-5 of max |ref| of one process's, chunked ==
    whole 0.0; (b) bf16 AdamW steps (``lc`` and ``afe`` 2 each, one
    ``lc`` at capacity factor 4; seq 1024, batch 8 in 2 microbatches):
    losses within 2e-2 of one process's (gradient norms too at ample
    capacity), launches and each axis's collectives exact, step ms and
    peak memory per rank; (c) the closed batch in bf16: 16/16 finished,
    the 4 ranks' tokens identical, ``moe_gmm`` counted per shape,
    collectives exact, step p50 / p99, tokens/s, peak memory per rank,
    the share of tokens equal to one process's and the margins where
    they first differ.  Training and prefill rounds run
    sequence-parallel over the model ranks (decode does not), their
    collectives counted exactly.
23. ``multi_pod``: a multi-pod mesh with a model axis: eight processes
    on the one card over gloo at ``(pod 2, data 2, model 2)``, granite at
    full width and 2 of its 24 layers, one ``afe`` and one ``lc`` step
    (seq 1024, batch 8 in 2 microbatches, sequence-parallel) against one
    process's: each rank's data group over ``("pod", "data")``, the mean
    loss over the data ranks within 2e-2, launches and each axis's
    collectives exact.
24. ``cp_decode``: context-parallel decode caches, the reference's
    layout (the self-attention caches' time axis over the model ranks,
    or at B 1 over the data and model ranks): gloo processes on the one
    card, fp32 — granite at full width and 4 of its 24 layers, B 8, a
    32,768-position cache over ``(data 1, model 2)``; the same at B 1
    over ``(data 2, model 2)``; hymba-1.5b at full width and 4 of its 32
    layers, B 8, its 1024-slot ring over ``(data 1, model 2)``.  Each
    rank fills the whole cache from a seed up to 8 positions before a
    block boundary (hymba: before the ring wraps), cuts its block and
    takes 16 decode steps across the boundary; the same process then
    takes them on the whole cache.  Gates: logits within 2e-5 of max
    |ref|, tokens equal, each rank's final block bit for bit the whole
    cache's at every position the steps did not write and within 2e-5
    of max |ref| at those they did, cache bytes the whole cache's / c,
    the context and model groups' collectives and ``moe_gmm``'s launches
    exact.

Each main-path run (each forward of phases 4, 7, 9, 10, 15 and 16; the
serve CLI and the batcher run of phase 5 for ``moe_gmm``; the four steps
of phases 13, 14 and 15 for the backward kernels, each EP round, each
rank's every step in phases 19 and 20, and phase 20's EP round under
autograd, each batcher run of phase 21, each rank's every step and its
batcher run in phase 22, each rank's every step in phase 23, each
rank's decode steps in phase 24) zeroes the
launch counters
just before it and reads them just after; the ``kernels`` line takes ``moe_gmm``'s
count from the serve CLI, ``ssm_scan``'s from the fp32 falcon-mamba-7b
forward, ``flash_attention``'s from the bf16 phi3-mini forward,
``flash_attention_bwd``'s and ``moe_gmm_bwd``'s from phase 13 (and a
second ``flash_attention_bwd`` entry, at whisper's cross-attention shape,
from phase 15) and ``ssm_scan_bwd``'s from phase 14; four more
entries give ``moe_gmm``'s and ``moe_gmm_bwd``'s launches on phase 20's
EP path (per round in (a), per step of expert rank 0 in (b)), and two
more ``moe_gmm``'s at one model rank of 2's serving shapes, with model
rank 0's launches in phase 21 (c); four more give ``moe_gmm`` and
``moe_gmm_bwd`` at one rank of ``(expert 2, model 2)``'s training shape
(rank 0's launches per ``lc`` step in phase 22 (b)) and ``moe_gmm`` at
its two serving shapes (rank 0's launches in phase 22 (c)).  Each
phase's wall time is printed
after it.  Launches made to compare a kernel with its plain
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
    """``(ms, "bytes" | "operations")`` on the H100 data sheet's dense
    peaks, the dry run's yardstick (``repro_torch.roofline.analysis``:
    3.35 TB/s of HBM3; bf16 989, fp32 67 (CUDA cores), TF32 495
    TFLOP/s)."""
    from repro_torch.roofline.analysis import bound_ms

    return bound_ms(nbytes, flops, dtype)


def mfu(cfg, kind: str, seq_len: int, batch: int, seconds: float) -> float:
    """Model-FLOPs utilisation of one step of ``seconds``: the reference's
    ``model_flops_estimate`` (6·N_active per trained token, 2·N_active
    per prefilled or decoded one) over the bf16 dense peak."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops_estimate

    return model_flops_estimate(cfg, ShapeConfig(kind, seq_len, batch,
                                                 kind)) \
        / (seconds * PEAK_FLOPS)


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
    expect = expected_launches(c32, prompt_len, 1, train=False)
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


def closed_batch(cfg) -> list:
    """The serving phases' closed batch: 16 requests of 128–384-token
    prompts drawn from ``SEED``, 32 new tokens each, all at step 0."""
    import numpy as np

    from repro_torch.serve import batcher as SB

    rng = np.random.default_rng(SEED)
    return [SB.Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, size=int(rng.integers(128, 385))).tolist(),
                max_new=32, arrive_step=0) for i in range(16)]


def drive_batcher(torch, b, reqs) -> list:
    """Submit ``reqs`` to the batcher ``b`` and step it until every request
    is done (at most 5000 steps); the host-clock ms of each step, taken
    after a synchronise on the card."""
    step_ms = []
    for r in reqs:
        b.submit(r)
    now = 0
    while (b.queued() or any(r is not None for r in b.slot_req)) \
            and now < 5000:
        ts = time.perf_counter()
        b.step(now)
        if b.device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        now += 1
    return step_ms


def counted_serve(torch, cfg, run) -> dict:
    """Run ``run()`` with the forward kernels' counters at 0, counting the
    model launches it makes (``prefill_step`` rounds, ``decode_step``
    steps), ``moe_gmm``'s launches inside each kind (its counter read
    around every call, ``moe_gmm_by_call``) and the ``(E, C)`` of each
    launch (``moe_gmm_shapes``: kind → {"E16 C8": launches}).
    ``moe_gmm`` must have launched once per layer of ``cfg`` per model
    launch of either kind, and nowhere else."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.models import model as TM

    calls = {"prefill": 0, "decode": 0}
    by_call = {"prefill": 0, "decode": 0}
    shapes = {"prefill": {}, "decode": {}, "outside": {}}
    real = {"prefill": TM.prefill_step, "decode": TM.decode_step}
    real_plan = MG.run_plan
    inside = []

    def counted(kind):
        def step(*a, **k):
            calls[kind] += 1
            inside.append(kind)
            n0 = MG.launches
            try:
                return real[kind](*a, **k)
            finally:
                by_call[kind] += MG.launches - n0
                inside.pop()
        return step

    def run_plan(buf, *a, **k):
        at = shapes[inside[-1] if inside else "outside"]
        key = f"E{buf.shape[0]} C{buf.shape[1]}"
        at[key] = at.get(key, 0) + 1
        return real_plan(buf, *a, **k)

    TM.prefill_step, TM.decode_step = counted("prefill"), counted("decode")
    MG.run_plan = run_plan
    try:
        MG.launches = FA.launches = 0
        run()
        torch.cuda.synchronize()
        got = {"moe_gmm": MG.launches, "flash_attention": FA.launches}
    finally:
        TM.prefill_step, TM.decode_step = real["prefill"], real["decode"]
        MG.run_plan = real_plan
    bad = [k for k in calls if by_call[k] != cfg.n_layers * calls[k]
           or sum(shapes[k].values()) != by_call[k]]
    if got["moe_gmm"] != sum(by_call.values()) or shapes["outside"] \
            or bad or not sum(calls.values()):
        raise AssertionError(f"moe_gmm launched {got['moe_gmm']} times, "
                             f"{by_call} in {calls} model launches of "
                             f"{cfg.n_layers} layers, shapes {shapes}")
    del shapes["outside"]
    return {"launches": got, "prefill_rounds": calls["prefill"],
            "decode_steps": calls["decode"], "moe_gmm_by_call": by_call,
            "moe_gmm_shapes": shapes}


def at_shape(shapes: dict, row: dict) -> int:
    """``moe_gmm``'s launches at the ``(E, C)`` of ``row`` (a
    :func:`phase_moe_gmm` row) in :func:`counted_serve`'s
    ``moe_gmm_shapes``, over both kinds of model launch."""
    return sum(k.get(f"E{row['E']} C{row['C']}", 0)
               for k in shapes.values())


def phase_serve(torch, cfg, card: str) -> dict:
    import numpy as np

    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as TM
    from repro_torch.serve import batcher as SB

    # 1. the CLI entry point, as a user runs it
    printed = io.StringIO()
    cli = {}

    def run_cli():
        with contextlib.redirect_stdout(printed):
            cli.update(launch_serve.main([
                "--arch", cfg.name, "--requests", "16", "--slots", "8",
                "--cache-len", "512"]))
    t0 = time.perf_counter()
    cli_counts = counted_serve(torch, cfg, run_cli)
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
    reqs = closed_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    b = SB.ContinuousBatcher(cfg, params, n_slots=8, cache_len=512,
                             policy="dlbc", prefill_chunk=32, device="cuda")
    step_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = counted_serve(torch, cfg, lambda: step_ms.extend(
        drive_batcher(torch, b, reqs)))
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.done_step is not None]
    gen_tokens = sum(len(r.tokens) - len(r.prompt) for r in reqs)
    bad = [t for r in reqs for t in r.tokens if not 0 <= t < cfg.vocab]
    row = {"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
           "card": card, "requests": len(reqs), "finished": len(done),
           "steps": len(step_ms), "generated_tokens": gen_tokens,
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "tokens_per_s": gen_tokens / wall, "wall_s": wall,
           # a decode step of the 8 slots at the median step time
           "mfu": mfu(cfg, "decode", 512, 8,
                      float(np.percentile(step_ms, 50)) / 1e3),
           "p50_step_ms": float(np.percentile(step_ms, 50)),
           "p99_step_ms": float(np.percentile(step_ms, 99)),
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9, **counts}
    emit(row)
    if len(done) != len(reqs) or gen_tokens != 32 * len(reqs) or bad:
        raise AssertionError("serving did not finish every request cleanly")
    row["cli_launches"] = cli_counts["launches"]
    row["cli_moe_gmm_shapes"] = cli_counts["moe_gmm_shapes"]
    row["tokens"] = [r.tokens[len(r.prompt):] for r in reqs]
    return row


# ---------------------------------------------------------------------------
# Phase 6: ssm_scan
# ---------------------------------------------------------------------------


#: falcon-mamba-7b's launch per 256-token chunk, from a zero and from a
#: carried state; a whole 2048-token layer; hymba-1.5b's ragged Di
SSM_SHAPES = (("falcon chunk", 1, 256, 8192, 16, False),
              ("falcon chunk, carried state", 1, 256, 8192, 16, True),
              ("falcon 2048-token layer", 1, 2048, 8192, 16, False),
              ("hymba chunk", 2, 256, 3200, 16, False))


def phase_ssm_scan(torch, shapes=SSM_SHAPES) -> list:
    """``shapes``: (what, B, L, Di, N, with a carried state) rows."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tol = 1e-4  # the reference's test_ssm_scan_sweep tolerance
    rows = []
    for what, B, L, Di, N, with_h0 in shapes:
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


SSM_BWD_SHAPES = (("hymba chunk", 1, 256, 3200, 16, False),
                  ("hymba chunk, carried state", 1, 256, 3200, 16, True),
                  ("falcon chunk", 1, 256, 8192, 16, False),
                  ("falcon chunk, carried state", 1, 256, 8192, 16, True))


def phase_ssm_scan_bwd(torch, shapes=SSM_BWD_SHAPES) -> list:
    """The backward kernel of ``ssm_scan`` (d_dA, d_dBx, dC, dh0) against
    the plain backward ``ssm_scan_bwd_ref`` and against autograd through
    the plain scan, each output within 1e-5 × its largest reference value,
    two calls bitwise equal, at the main path's chunks (``shapes``: what,
    B, L, Di, N, carried): hymba-1.5b's (B 1, L 256, Di 3200) and
    falcon-mamba-7b's (Di 8192), from a zero state with no ``dh_last`` (a
    sequence's only chunk) and from a carried state with one (the middle
    chunks)."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tol = 1e-5
    names = ("d_dA", "d_dBx", "dC", "dh0")
    rows = []
    for what, B, L, Di, N, carried in shapes:
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
        cfg, prompt_len, 1, train=False)["flash_attention"],
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
                global_batch: int = 8, microbatches: int = 2,
                remat: bool = True):
    """The training step of phase 13, which
    ``benchmarks/torch_train_profile.py`` profiles: ``cfg`` on the card
    with random weights from ``seed``, ``init_opt_state`` and
    ``build_train_step`` (``seq_len`` tokens, ``global_batch`` sequences
    in ``microbatches``, policy ``afe``, sched policy ``dlbc``, ``remat``
    (each layer checkpointed; the default), AdamW at lr 1e-4 with warmup
    1) and one fixed batch (with seeded frame or patch
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
        policy="afe", sched_policy="dlbc", remat=remat), ocfg)
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
                      ssm_chunk: int = 256, *, train: bool = True,
                      remat: bool = True) -> dict:
    """Each kernel's launches per microbatch: one per attention layer
    (encdec: each encoder layer, and each decoder layer twice, self and
    cross; vlm: each self and each cross layer), one per MoE layer, one
    per mamba layer and ``ssm_chunk`` tokens in a forward
    (``train=False``).  A training pass (forward + backward) launches
    each backward kernel once per forward site, and its forward kernels
    again where autograd rematerialises: with ``remat`` every layer runs
    twice (the forward, then its recompute in the backward), and a
    mamba chunk's scan three times (the forward, the layer's recompute,
    then the chunk's own checkpoint inside it); without ``remat`` the
    layers once and the scan twice (its chunk is checkpointed whatever
    ``remat`` says, as the reference's ``chunk_body``)."""
    L = cfg.n_layers
    attn = {"ssm": 0, "encdec": cfg.enc_layers + 2 * L}.get(cfg.family, L)
    per = {"flash_attention": attn,
           "moe_gmm": L if cfg.n_experts else 0,
           "ssm_scan": L * max(1, seq_len // ssm_chunk)
           if cfg.family in ("ssm", "hybrid") else 0}
    again = {"flash_attention": 2 if remat else 1,
             "moe_gmm": 2 if remat else 1, "ssm_scan": 3 if remat else 2}
    out = {}
    for k, n in per.items():
        out[k] = n * microbatches * (again[k] if train else 1)
        if train:
            out[k + "_bwd"] = n * microbatches
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
                global_batch: int = 8, microbatches: int = 2,
                remat: bool = True) -> dict:
    """``cfg`` at full width (bf16): the step of :func:`train_setup`
    (``build_train_step`` + ``init_opt_state``, policy ``afe``, sched
    policy ``dlbc``, ``remat`` as given); ``steps`` AdamW steps (lr 1e-4,
    warmup 1) on one fixed batch.  Every step must launch each kernel and
    each backward kernel exactly as :func:`expected_launches` says
    (granite with ``remat``: 24 × 2 × 2 of ``flash_attention`` and
    ``moe_gmm``, 24 × 2 of each backward; hymba-1.5b at 8 microbatches:
    32 × 8 × 2 of ``flash_attention`` and 32 × 4 chunks × 8 × 3 of
    ``ssm_scan``); losses finite and falling; peak memory and step times
    printed."""
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    step, params, opt, batch, shape = train_setup(
        torch, cfg, seq_len=seq_len, global_batch=global_batch,
        microbatches=microbatches, remat=remat)
    S, B, Mb = shape.seq_len, shape.global_batch, shape.microbatches
    expect = expected_launches(cfg, S, Mb, remat=remat)
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
           "policy": "afe", "sched_policy": "dlbc", "remat": remat,
           "steps": steps,
           "losses": losses, "grad_norms": norms,
           "nonfinite_skipped": sum(skipped), "step_ms": step_ms,
           "first_step_ms": step_ms[0], "rest_step_ms": rest,
           "tokens_per_s": B * S / rest * 1e3,
           "mfu": mfu(cfg, "train", S, B, rest / 1e3),
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


def phase_train_fit(torch, cfg, card: str, microbatches: int) -> dict:
    """Whether ``cfg``'s training step at seq 1024, global batch 8 fits
    the card in ``microbatches`` (with ``remat``): :func:`phase_train`'s
    row when it does; when the card runs out of memory, a row that says
    so (the finding: the step keeps its smaller microbatches)."""
    import gc

    try:
        row = phase_train(torch, cfg, card, 4, 1024, 8, microbatches)
        row = {"phase": "train_fit", "fits": True, **{
            k: row[k] for k in ("arch", "microbatches", "rest_step_ms",
                                "tokens_per_s", "max_memory_allocated_gb")}}
    except torch.cuda.OutOfMemoryError as e:
        row = {"phase": "train_fit", "arch": cfg.name, "fits": False,
               "microbatches": microbatches, "error": str(e)[:300]}
    gc.collect()
    torch.cuda.empty_cache()
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Phases 17-18: distribution (world size 1, NCCL) and the EP round
# ---------------------------------------------------------------------------


def nccl_world_of_one(torch):
    """A one-rank NCCL process group (a file store under ``build/``)."""
    import shutil

    import torch.distributed as dist

    store = ROOT / "build" / f"chip_smoke_nccl_{os.getpid()}"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    return store


def expected_collectives(cfg, policy: str, microbatches: int,
                         n_buckets: int, model: int = 1,
                         data: int = 1) -> dict:
    """A step's collectives over the data axes by kind, from the param
    tree (one of ``model`` model ranks' compute shards) and the bucket
    plan: ``unopt`` all-reduces every leaf per microbatch, ``lc`` once;
    ``afe`` reduce-scatters and all-gathers each FSDP-sharded leaf and
    all-reduces each replicated one and the norm's sums; ``afe_bucket``
    reduce-scatters each bucket's sharded leaves, all-reduces the
    replicated ones as one bucket and the norm's sums, and all-gathers
    each bucket's sharded params by dtype.  On ``data > 1`` data ranks a
    MoE layer (no expert axis) all-gathers the ranks' pair counts once
    (``lc`` dispatch) or twice (``dlbc``) per forward, its ``remat``
    recompute included (ROADMAP fault M)."""
    from repro_torch.distributed.sharding import (
        MeshShape, fsdp_layout, mesh_context, tp_local_params)
    from repro_torch.models import model as TM
    from repro_torch.sched import FixedCapacity
    from repro_torch.train.train_step import _bucket_bins
    from repro_torch.tree import tree_leaves

    shapes = TM.param_shapes(cfg)
    if model > 1:
        shapes = tp_local_params(shapes, cfg, 0, model)
    leaves = tree_leaves(shapes)
    with mesh_context(MeshShape(("data", "model"), (1, model))):
        dims = tree_leaves(fsdp_layout(shapes, cfg, 0, 1).dims)
    n, ns = len(leaves), sum(d is not None for d in dims)
    out = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                         "all_to_all", "send_recv"), 0)
    if policy == "unopt":
        out["all_reduce"] = microbatches * n
    elif policy == "lc":
        out["all_reduce"] = n
    elif policy == "afe":
        out.update(reduce_scatter=ns, all_gather=ns, all_reduce=n - ns + 1)
    else:
        bins = [[i for i in b if dims[i] is not None] for b in _bucket_bins(
            leaves, n_buckets, "dlbc", FixedCapacity(
                idle_n=n_buckets - 1, total_n=n_buckets))]
        out.update(reduce_scatter=sum(1 for b in bins if b),
                   all_reduce=(1 if n > ns else 0) + 1,
                   all_gather=sum(len({leaves[i].dtype for i in b})
                                  for b in bins))
    if data > 1 and cfg.family == "moe":
        rounds = 1 if cfg.moe_dispatch == "lc" else 2
        out["all_gather"] += microbatches * 2 * cfg.n_layers * rounds
    return out


def phase_dist_policies(torch, cfg, card: str, steps: int = 2) -> dict:
    """``cfg`` at full width (bf16; :func:`main` passes 4 of granite's
    layers), seq 1024, global batch 8 in 2 microbatches: ``steps`` AdamW
    steps of each policy (``unopt``, ``lc``,
    ``afe``, ``afe_bucket``) on a ``make_test_mesh(data=1, model=1)``
    NCCL mesh, and the same steps without a mesh from the same seed,
    under deterministic algorithms (the embedding gradient's scatter-add
    would otherwise sum in another order each run).  The params must be
    bitwise equal (a one-rank all-reduce, reduce-scatter or all-gather is
    a copy), and each step's collective counts those of
    :func:`expected_collectives`."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import parity_mode
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, build_train_step
    from repro_torch.tree import tree_leaves

    store = nccl_world_of_one(torch)
    parity_mode(deterministic=True)
    shape = ShapeConfig("train", 1024, 8, "train", microbatches=2)
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=1)
    rows = []
    try:
        mesh = make_test_mesh(data=1, model=1)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        toks = torch.randint(0, cfg.vocab, (8, 1025), generator=gen,
                             device="cuda")
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        for policy in ("unopt", "lc", "afe", "afe_bucket"):
            got, ms, counts = {}, {}, []
            for where in ("none", "mesh"):
                with mesh_context(mesh if where == "mesh" else None):
                    params = TM.init_params(cfg, torch.Generator(
                        device="cuda").manual_seed(SEED), device="cuda")
                    step, _ = build_train_step(cfg, shape, StepConfig(
                        policy=policy), ocfg)
                    opt = init_opt_state(params, ocfg, layout=step.layout)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        params, opt, m = step(params, opt, batch)
                        if where == "mesh":
                            counts.append(m["collectives"])
                    torch.cuda.synchronize()
                ms[where] = (time.perf_counter() - t0) * 1e3 / steps
                got[where] = tree_leaves(params)
                del opt, m
            equal = all(torch.equal(a, b)
                        for a, b in zip(got["none"], got["mesh"]))
            worst = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got["none"], got["mesh"]))
            expect = expected_collectives(cfg, policy, 2,
                                          StepConfig().n_buckets)
            row = {"phase": "dist_policies", "arch": cfg.name,
                   "dtype": cfg.dtype, "card": card, "policy": policy,
                   "world_size": dist.get_world_size(), "backend":
                       dist.get_backend(), "steps": steps,
                   "params_bitwise_equal": equal, "max_abs_diff": worst,
                   "collectives_per_step": counts,
                   "expected_per_step": expect,
                   "step_ms_no_mesh": ms["none"], "step_ms_mesh": ms["mesh"]}
            emit(row)
            rows.append(row)
            del got, params
            torch.cuda.empty_cache()
            if not equal:
                raise AssertionError(f"dist_policies {policy}: params differ "
                                     f"from the mesh-free steps by {worst}")
            if any(c != expect for c in counts):
                raise AssertionError(f"dist_policies {policy}: collectives "
                                     f"{counts} != {expect}")
    finally:
        parity_mode(deterministic=False)
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return rows


def phase_ep_round(torch, cfg, card: str, T: int = 1024) -> list:
    """``ep_round`` on a one-rank expert axis (``make_test_mesh(data=1,
    model=1, expert=1)``, NCCL) at ``cfg``'s full MoE width, ``T`` tokens,
    capacity factor E / top_k (ample), fp32 (TF32 off) and bf16: equal to
    the single-host ``moe_apply`` (fp32 max |Δ| < 1e-5, bf16 within the
    ``moe_gmm`` tolerance), ``joins == rounds == 1``, exactly one
    ``moe_gmm`` launch per round; the round's and ``moe_apply``'s times
    (CUDA events, mean of 10 after 2 warm-up)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.device import torch_dtype
    from repro_torch.ep.dispatch import ep_round
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.sched import SchedTelemetry

    store = nccl_world_of_one(torch)
    rows = []
    try:
        mesh = make_test_mesh(data=1, model=1, expert=1)
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(
                cfg, dtype=dtype, expert_parallel=True,
                moe_capacity_factor=cfg.n_experts / cfg.top_k)
            host = dataclasses.replace(c, expert_parallel=False)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            p = M.moe_init(gen, c, torch_dtype(dtype))
            x = torch.randn(T, c.d_model, generator=gen,
                            device="cuda").to(torch_dtype(dtype))
            want = M.moe_apply(p, host, x)
            tel = SchedTelemetry()
            torch.cuda.synchronize()
            MG.launches = 0
            got, st = ep_round(p, c, x, mesh=mesh, telemetry=tel)
            launches = MG.launches
            tol = 1e-5 if dtype == "float32" else 2e-2 * 5
            err = max_err(torch, got, want, tol, 0.0 if dtype == "float32"
                          else tol, f"ep_round {dtype}")
            ep_ms = time_ms(torch, lambda: ep_round(p, c, x, mesh=mesh), 10)
            host_ms = time_ms(torch, lambda: M.moe_apply(p, host, x), 10)
            row = {"phase": "ep_round", "arch": cfg.name, "card": card,
                   "dtype": dtype, "T": T, "E": c.n_experts, "top_k":
                       c.top_k, "capacity_factor": c.moe_capacity_factor,
                   "n_shards": st["n_shards"], "world_size":
                       dist.get_world_size(), "backend": dist.get_backend(),
                   "max_abs_err": err, "tol": tol, "joins": tel.joins,
                   "rounds": st["rounds"], "spawns": st["spawns"],
                   "sent": st["sent"], "dropped": st["dropped"],
                   "moe_gmm_launches_per_round": launches,
                   "ep_round_ms": ep_ms, "moe_apply_ms": host_ms}
            emit(row)
            rows.append(row)
            if not (tel.joins == st["rounds"] == st["joins"] == 1
                    and launches == 1 and st["dropped"] == 0):
                raise AssertionError(f"ep_round {dtype}: {row}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 19: tensor parallelism, two model ranks on the one card
# ---------------------------------------------------------------------------


def tp_step_setup(torch, cfg, mesh, *, seq_len: int, global_batch: int,
                  microbatches: int, lr: float, ssm_chunk: int = 256,
                  dev: str = "cuda", policy: str = "lc"):
    """``build_train_step`` under ``mesh`` (None: one process) with
    ``policy`` (by default ``lc``, every collective an all-reduce),
    sched policy ``dlbc`` and
    ``remat``; whole weights from ``SEED``, cut to this rank's compute
    shards (``step.local_state``); AdamW at ``lr``, warmup 1, its state
    laid out by ``step.layout``; one batch from the same generator.
    Returns (step, params, opt, batch)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.models import model as TM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, build_train_step

    shape = ShapeConfig("train", seq_len, global_batch, "train",
                        microbatches=microbatches)
    ocfg = AdamWConfig(lr=lr, warmup_steps=1)
    with mesh_context(mesh):
        step, _ = build_train_step(cfg, shape, StepConfig(
            policy=policy, sched_policy="dlbc", ssm_chunk=ssm_chunk), ocfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = step.local_state(TM.init_params(cfg, gen, device=dev))
    opt = init_opt_state(params, ocfg, layout=step.layout)
    toks = torch.randint(0, cfg.vocab, (global_batch, seq_len + 1),
                         generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             **ctx_input(torch, cfg, global_batch, gen, device=dev)}
    return step, params, opt, batch


def tp_steps(torch, step, params, opt, batch, steps: int,
             dev: str = "cuda") -> dict:
    """``steps`` steps on one batch: losses, gradient norms, skipped steps,
    host-clock step ms (synchronised) and, per step, the kernel launches
    and the collectives of the data, model and expert axes.  On the card
    also each step's activation memory, ``activation_gb``: the peak
    allocated during the step less what was allocated just before it
    (params, optimizer state and the batch excluded; the step's
    gradients, their accumulators and the saved activations included),
    and ``max_memory_allocated_gb``, the peak since the caller last reset
    the peak statistics (the setup) or over any step."""
    out = {"losses": [], "grad_norms": [], "skipped": [], "step_ms": [],
           "launches": [], "collectives": [], "tp_collectives": [],
           "ep_collectives": [], "activation_gb": []}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    for _ in range(steps):
        zero_counters()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            top = torch.cuda.max_memory_allocated()
            peak = max(peak, top)
            out["activation_gb"].append((top - before) / 1e9)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(read_counters())
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["skipped"].append(int(m["nonfinite_skipped"]))
        for k in ("collectives", "tp_collectives", "ep_collectives"):
            out[k].append(m[k])
    out["max_memory_allocated_gb"] = peak / 1e9
    return out


def tp_fp32_check(torch, cfg, mesh, rank: int, S: int, ssm_chunk: int,
                  dev: str = "cuda") -> dict:
    """``cfg`` (fp32, 2 layers) at B 2 x ``S``: one step on the model
    axis against the one-process step from the same weights and batch,
    this rank's shards compared: the params after the step, the first
    moment ``m`` (0.1 x the clipped gradient) within 1e-4 of each leaf's
    largest value, the gradient norm, and the step's kernel launches."""
    from repro_torch.distributed.sharding import tp_local_params
    from repro_torch.tree import tree_leaves

    kw = dict(seq_len=S, global_batch=2, microbatches=1, lr=2e-5,
              ssm_chunk=ssm_chunk, dev=dev)
    step, p, o, batch = tp_step_setup(torch, cfg, None, **kw)
    p, o, m = step(p, o, batch)
    want = [tree_leaves(tp_local_params(t, cfg, rank, 2))
            for t in (p, o["m"])]
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del step, p, o, m
    step, p, o, batch = tp_step_setup(torch, cfg, mesh, **kw)
    got = tp_steps(torch, step, p, o, batch, 1, dev)
    param_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(p), want[0]))
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(tree_leaves(o["m"]), want[1]))
    return {"arch": cfg.name, "n_experts": cfg.n_experts,
            "n_heads": cfg.n_heads, "S": S, "ssm_chunk": ssm_chunk,
            "loss": got["losses"][0], "one_process_loss": one["loss"],
            "grad_norm": got["grad_norms"][0],
            "one_process_grad_norm": one["grad_norm"],
            "param_max_abs_err": param_err,
            "m_max_err_over_max": grad_err,
            "launches": got["launches"][0],
            "tp_collectives": got["tp_collectives"][0]}


def tp_rank_run(torch, rank: int, plan: dict) -> dict:
    """One model rank of :func:`phase_tp_train`: the fp32 checks, then the
    full-width bf16 steps, on a ``(data 1, model 2)`` mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_leaves

    dev = plan["dev"]
    mesh = make_test_mesh(data=1, model=2, device_type="cpu")
    out = {"fp32": []}
    for arch, rep, S, chunk in plan["fp32"]:
        c = dataclasses.replace(get_config(arch, smoke=plan["smoke"]),
                                dtype="float32", n_layers=2, **rep)
        out["fp32"].append(tp_fp32_check(torch, c, mesh, rank, S, chunk,
                                         dev))
    arch, steps, S, B, mb = plan["bf16"]
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step, p, o, batch = tp_step_setup(
        torch, get_config(arch, smoke=plan["smoke"]), mesh, seq_len=S,
        global_batch=B, microbatches=mb, lr=1e-4, dev=dev)
    out["bf16_bytes"] = {k: sum(t.numel() * t.element_size()
                                for t in tree_leaves(v))
                         for k, v in (("params", p), ("opt_state", o))}
    out["bf16"] = tp_steps(torch, step, p, o, batch, steps, dev)
    return out


def ep_rank_run(torch, rank: int, plan: dict) -> dict:
    """One rank of :func:`phase_ep_train` (b) and (c): for each case
    ``(policy, capacity factor or None for the config's, steps)``,
    full-width bf16 steps of ``plan["layers"]`` layers on an ``(expert 2,
    data plan["data"], model 1)`` mesh,
    with the rank's peak memory; the results in the cases' order."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh

    dev = plan["dev"]
    mesh = make_test_mesh(data=plan["data"], model=1, expert=2,
                          device_type="cpu")
    arch, S, B, mb = plan["bf16"]
    base = dataclasses.replace(get_config(arch, smoke=plan["smoke"]),
                               expert_parallel=True,
                               n_layers=plan["layers"])
    out = []
    for policy, cf, steps in plan["cases"]:
        cfg = base if cf is None else \
            dataclasses.replace(base, moe_capacity_factor=cf)
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        step, p, o, batch = tp_step_setup(
            torch, cfg, mesh, seq_len=S, global_batch=B, microbatches=mb,
            lr=1e-4, dev=dev, policy=policy)
        res = tp_steps(torch, step, p, o, batch, steps, dev)
        res["local_experts"] = int(p["layers"]["moe"]["w1"].shape[-3])
        out.append(res)
        del step, p, o, batch
    return out


def tp_rank(rank: int, store: str, plan: dict, q) -> None:
    """A spawned rank: a gloo process group of ``plan["world"]`` ranks
    (default 2; NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through host memory), then :func:`tp_rank_run`
    (:func:`ep_rank_run` for a plan of kind ``"ep"``,
    :func:`tp_serve_rank_run` for one of kind ``"serve"``,
    :func:`ep_tp_rank_run` for one of kind ``"ep_tp"``,
    :func:`multi_pod_rank_run` for one of kind ``"multi_pod"``,
    :func:`cp_decode_rank_run` for one of kind ``"cp_decode"``); the
    result or the traceback goes on ``q``."""
    import traceback

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    try:
        if plan["dev"] == "cuda":
            torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=plan.get("world", 2))
        run = {"ep": ep_rank_run, "serve": tp_serve_rank_run,
               "ep_tp": ep_tp_rank_run,
               "multi_pod": multi_pod_rank_run,
               "cp_decode": cp_decode_rank_run}.get(plan.get("kind"),
                                                    tp_rank_run)
        q.put((rank, run(torch, rank, plan)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_spawn(plan: dict) -> dict:
    """Run :func:`tp_rank` in ``plan["world"]`` (default 2) spawned
    processes; their results by rank.  Raises with the tracebacks if a
    rank fails; never leaves one running."""
    import multiprocessing as mp
    import shutil

    store = ROOT / "build" / f"chip_smoke_tp_{os.getpid()}"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    world = plan.get("world", 2)
    procs = [ctx.Process(target=tp_rank, args=(r, str(store / "store"),
                                               plan, q))
             for r in range(world)]
    for pr in procs:
        pr.start()
    got = {}
    try:
        while len(got) < world:
            r, res = q.get(timeout=600)
            got[r] = res
            if "error" in res:
                break
    finally:
        for pr in procs:
            pr.join(30)
            if pr.is_alive():
                pr.kill()
                pr.join()
        shutil.rmtree(store, ignore_errors=True)
    errors = [f"rank {r}:\n{res['error']}" for r, res in got.items()
              if "error" in res]
    if errors:
        raise AssertionError(f"{plan.get('kind', 'tp')} ranks: " +
                             "".join(errors))
    return got


def tp_expected(cfg, microbatches: int) -> dict:
    """The model axis's collectives per train step of a MoE config whose
    experts split over 2 model ranks (E or d_ff; no expert axis), under
    ``remat``, sequence-parallel (2 divides S).  Per microbatch, ``L``
    layers: forward, the embedding's reduce-scatter, per layer the two
    normed inputs' all-gathers and the reduce-scatters of attention's and
    the experts' outputs, the head input's all-gather and the cross
    entropy's three all-reduces; the recompute (up to the layer's last
    saved tensor, before the experts' reduce-scatter) re-issues the two
    all-gathers and attention's reduce-scatter; backward, each
    reduce-scatter's gradient all-gathered and each all-gather's
    reduce-scatter (the embedding's and the head input's too), and the
    gates' gradient all-reduced per layer: ``6L + 2`` all-gathers, ``5L +
    2`` reduce-scatters, ``L + 3`` all-reduces.  Per step the norms'
    partial gradients summed and the gradient norm: two all-reduces."""
    L, M = cfg.n_layers, microbatches
    return dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0) | {
        "all_gather": M * (6 * L + 2), "reduce_scatter": M * (5 * L + 2),
        "all_reduce": M * (L + 3) + 2}


def phase_tp_train(torch, cfg, hymba, card: str) -> list:
    """Tensor parallelism on a ``(data 1, model 2)`` mesh: two processes on
    the one card, gloo, policy ``lc`` (:func:`tp_step_setup`).

    * fp32, 2 layers, TF32 off (:func:`tp_fp32_check`), each rank against
      the one-process step on its shards: granite with E over the model
      axis (E 16 per rank), a granite copy with E = 3 (top-2), whose d_ff
      goes over it instead (f 256), and hymba-1.5b (Di 1600 per rank in
      two 128-token scan chunks; its 25 heads do not split over 2, so its
      attention runs whole on both ranks): params within 1e-4, ``m``
      within 1e-4 of each leaf's largest value, the gradient norm within
      1e-4 relative, launches exactly :func:`expected_launches` of the
      rank-local config.
    * granite at full width (bf16, 24 layers), seq 1024, global batch 8 in
      2 microbatches, 2 AdamW steps: each step's loss and gradient norm
      within 2e-2 relative of the one-process steps (run here first, same
      seed), each rank's launches per step exactly ``expected_launches``
      of the rank-local config, per-rank peak memory.  Step times include
      gloo's host staging of every all-reduce (nothing here measures
      NVLink)."""
    import gc

    from repro_torch.distributed.sharding import tp_local_config

    torch.cuda.reset_peak_memory_stats()
    one = tp_steps(torch, *tp_step_setup(
        torch, cfg, None, seq_len=1024, global_batch=8, microbatches=2,
        lr=1e-4), 2)
    gc.collect()
    torch.cuda.empty_cache()
    plan = {"dev": "cuda", "smoke": False,
            "fp32": [(cfg.name, {}, 256, 256),
                     (cfg.name, {"n_experts": 3, "top_k": 2}, 256, 256),
                     (hymba.name, {}, 256, 128)],
            "bf16": (cfg.name, 2, 1024, 8, 2)}
    got = tp_spawn(plan)
    rows, bad = [], []
    for i, (arch, rep, S, chunk) in enumerate(plan["fp32"]):
        c = dataclasses.replace(cfg if arch == cfg.name else hymba,
                                n_layers=2, **rep)
        local = tp_local_config(c, 2)
        expect = expected_launches(local, S, 1, chunk)
        # the model axis's counts are derived for granite's shape only
        tp_want = tp_expected(c, 1) if c.family == "moe" else None
        for r in range(2):
            row = {"phase": "tp_train", "check": "fp32", "rank": r,
                   "card": card, **got[r]["fp32"][i],
                   "expected_launches": expect,
                   "expected_tp_collectives": tp_want}
            emit(row)
            rows.append(row)
            gn, g1 = row["grad_norm"], row["one_process_grad_norm"]
            if row["param_max_abs_err"] > 1e-4 or \
                    row["m_max_err_over_max"] > 1e-4 or \
                    abs(gn - g1) > 1e-4 * g1 or row["launches"] != expect \
                    or tp_want not in (None, row["tp_collectives"]):
                bad.append(f"fp32 {arch} {rep} rank {r}")
    local = tp_local_config(cfg, 2)
    expect = expected_launches(local, 1024, 2)
    tp_want = tp_expected(cfg, 2)
    for r in range(2):
        b = got[r]["bf16"]
        row = {"phase": "tp_train", "check": "bf16", "rank": r,
               "card": card, "arch": cfg.name, "mesh": "data 1, model 2",
               "backend": "gloo", "policy": "lc", "seq_len": 1024,
               "global_batch": 8, "microbatches": 2,
               "local_shapes": {"n_heads": local.n_heads,
                                "n_kv_heads": local.n_kv_heads,
                                "n_experts": local.n_experts},
               **b, "one_process_losses": one["losses"],
               "one_process_grad_norms": one["grad_norms"],
               "one_process_step_ms": one["step_ms"],
               "one_process_max_memory_allocated_gb":
                   one["max_memory_allocated_gb"],
               "one_process_activation_gb": one["activation_gb"],
               "bf16_bytes": got[r]["bf16_bytes"],
               "expected_launches_per_step": expect,
               "expected_tp_collectives_per_step": tp_want}
        emit(row)
        rows.append(row)
        for x, y in zip(b["losses"] + b["grad_norms"],
                        one["losses"] + one["grad_norms"]):
            if not math.isfinite(x) or abs(x - y) > 2e-2 * abs(y):
                bad.append(f"bf16 rank {r}: {x} against {y}")
        if sum(b["skipped"]) or any(n != expect for n in b["launches"]) \
                or any(n != tp_want for n in b["tp_collectives"]):
            bad.append(f"bf16 rank {r}: skipped {b['skipped']}, launches "
                       f"{b['launches']}, model axis "
                       f"{b['tp_collectives']}")
    if bad:
        raise AssertionError(f"tp_train: {bad}")
    return rows


def phase_dryrun(torch, cfg, card: str, tp_rows: list) -> dict:
    """The dry run (``repro_torch.launch.dryrun.trace_step``) of
    :func:`phase_tp_train`'s bf16 configuration — granite at full width,
    seq 1024, global batch 8 in 2 microbatches, ``lc``, ``(data 1, model
    2)`` — traced for rank 0 on the meta device: no storage, no launch.
    Gates, against what the two ranks measured on the card: the model
    axis's collectives per step (292 / 244 / 56), each kernel's traced
    calls equal to a step's launches, the traced argument bytes of the
    params and the optimizer state equal to the rank's exactly, the card's
    ``total_memory`` the dry run's ``HBM_BYTES``.  Prints the traced
    activation bytes (the tensors autograd saves, at their peak) beside
    the ranks' ``activation_gb`` (peak allocated over the step less
    before it: the gradients and their fp32 accumulators too), and the
    roofline terms on the H100's constants."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline.analysis import (
        model_flops_estimate, roofline_fraction, roofline_from_opcost)

    shape = ShapeConfig("train", 1024, 8, "train", microbatches=2)
    t0 = time.perf_counter()
    got = DR.trace_step(cfg, shape, MeshShape(("data", "model"), (1, 2)),
                        policy="lc")
    trace_s = time.perf_counter() - t0
    terms = roofline_from_opcost(got["cost"], chips=2,
                                 model_flops=model_flops_estimate(cfg, shape))
    rank0 = next(r for r in tp_rows
                 if r["check"] == "bf16" and r["rank"] == 0)
    real = rank0["bf16_bytes"]
    mem = got["memory"]
    calls = {k: v["calls"] for k, v in got["kernels"].items()}
    launched = {k: n for k, n in rank0["launches"][0].items() if n}
    total = torch.cuda.get_device_properties(0).total_memory
    row = {"phase": "dryrun", "card": card, "arch": cfg.name,
           "mesh": "data 1, model 2", "policy": "lc", "seq_len": 1024,
           "global_batch": 8, "microbatches": 2, "trace_s": trace_s,
           "model_collectives": got["collectives"]["model"],
           "measured_model_collectives": rank0["tp_collectives"][0],
           "kernel_calls": calls, "measured_launches": launched,
           "memory": mem, "measured_bytes": real,
           "activation_gb": mem["activation_bytes"] / 1e9,
           "measured_activation_gb": rank0["activation_gb"],
           "total_memory": total, "dryrun_hbm_bytes": DR.HBM_BYTES,
           "cost": got["cost"].as_dict(), "roofline": terms.as_dict(),
           "roofline_fraction": roofline_fraction(terms)}
    emit(row)
    bad = []
    if row["model_collectives"] != row["measured_model_collectives"]:
        bad.append(f"model axis {row['model_collectives']} against "
                   f"{row['measured_model_collectives']}")
    if calls != launched:
        bad.append(f"kernel calls {calls} against launches {launched}")
    if (mem["params_bytes"], mem["opt_state_bytes"]) != \
            (real["params"], real["opt_state"]):
        bad.append(f"bytes {mem['params_bytes']} + {mem['opt_state_bytes']}"
                   f" against {real['params']} + {real['opt_state']}")
    if total != DR.HBM_BYTES:
        bad.append(f"total_memory {total} against HBM_BYTES "
                   f"{DR.HBM_BYTES}")
    if bad:
        raise AssertionError(f"dryrun: {bad}")
    return row


# ---------------------------------------------------------------------------
# Phase 20: expert parallelism under autograd
# ---------------------------------------------------------------------------


def ep_expected_collectives(cfg, microbatches: int,
                            remat: bool = True) -> dict:
    """The expert axis's collectives per train step: per MoE layer and
    microbatch the round's two all-to-alls and output all-gather forward,
    its two all-to-alls and token all-gather backward, and under ``remat``
    the recompute's two all-to-alls (it stops at the gate-combine's saved
    input, before the output gather); per step the router's gradient sum
    and the norm's all-reduce."""
    n = cfg.n_layers * microbatches
    out = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                         "all_to_all", "send_recv"), 0)
    out.update(all_to_all=(6 if remat else 4) * n, all_gather=2 * n,
               all_reduce=2)
    return out


def phase_ep_train(torch, cfg, card: str, T: int = 4096,
                   with_ranks: bool = True, layers: int = 4) -> list:
    """Expert parallelism under autograd.

    (a) One NCCL rank, an expert axis of 1: the EP round
    (``ep_dispatch_combine`` with an expert-group ``Collectives``) forward
    and backward at ``cfg``'s full MoE width (E 32, top-8, d 1024, f 512)
    on ``T`` tokens (a training microbatch of 4 x 1024: C 1280 at
    capacity factor 1.25), fp32 (TF32 off) and bf16, against the
    single-host ``moe_apply``'s forward and backward on the same weights,
    tokens and output gradient: each gradient (x, router, w1, w3, w2)
    within 1e-4 (fp32) or 0.1 (bf16, the ``moe_gmm`` tolerance) of its
    largest reference value; exactly one ``moe_gmm`` and one
    ``moe_gmm_bwd`` launch per round, and two all-to-alls and one
    all-gather each way; forward + backward times of both (CUDA events,
    mean of 5 after 2 warm-up).

    (b) Two processes on the one card over gloo, an ``(expert 2, data 1,
    model 1)`` mesh, ``cfg`` at full width and ``layers`` of its layers
    (phase 22 runs the expert axis at full depth beside a model axis) in bf16 with ``expert_parallel``, seq 1024, global batch 8 in 2
    microbatches,
    policies ``lc`` and ``afe``, 2 AdamW steps each at the config's
    capacity (C 1280), and one ``lc`` step at capacity factor E / top_k
    (ample, C 4096): every step's loss within 2e-2 relative of the
    one-process steps, and at ample capacity the gradient norm too (under
    pressure the round admits per lane and local expert, the single-host
    dispatch per expert over all tokens, with its re-route); per-rank
    launches exactly ``expected_launches`` of the rank-local config (E
    16), the expert and data axes' collectives exactly, no skipped step;
    per-rank step ms and peak memory.

    (c) Four processes at ``(expert 2, data 2, model 1)``, the same
    layers, batch and seed: 2 ``lc`` steps at the config's capacity.
    Each data rank's round all-gathers both data ranks' token rows and
    runs on the whole microbatch (the reference's lanes and capacities),
    so the gates are (b)'s: the losses' mean over the data ranks within
    2e-2 of the one-process steps,
    launches and the expert axis's collectives as on a data axis of 1,
    the data axis's those of ``lc`` plus one all-gather per MoE layer
    and forward (``2 · microbatches · layers`` with remat)."""
    import gc
    import shutil

    import torch.distributed as dist

    from repro_torch.distributed.comm import Collectives
    from repro_torch.device import torch_dtype
    from repro_torch.ep.dispatch import ep_dispatch_combine
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.train.train_step import StepConfig

    names = ("x", "router", "w1", "w3", "w2")
    one_way = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 1,
               "all_to_all": 2, "send_recv": 0}
    store = nccl_world_of_one(torch)
    rows = []
    try:
        group = make_test_mesh(data=1, model=1, expert=1).get_group("expert")
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype, expert_parallel=True)
            host = dataclasses.replace(c, expert_parallel=False)
            dt = torch_dtype(dtype)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            p = M.moe_init(gen, c, dt)
            x = torch.randn(T, c.d_model, generator=gen, device="cuda").to(dt)
            dout = torch.randn(T, c.d_model, generator=gen,
                               device="cuda").to(dt)

            def run(ep):
                ins = [t.detach().clone().requires_grad_(True)
                       for t in (x, p["router"], p["w1"], p["w3"], p["w2"])]
                pp = dict(zip(names[1:], ins[1:]))
                y = M.moe_apply(pp, host, ins[0]) if ep is None else \
                    ep_dispatch_combine(pp, c, ins[0], comm=ep)
                return y, torch.autograd.grad(y, ins, dout)

            want_y, want = run(None)
            ep = Collectives(group)
            torch.cuda.synchronize()
            zero_counters()
            got_y, got = run(ep)
            torch.cuda.synchronize()
            launches = read_counters()
            tol = 1e-4 if dtype == "float32" else 0.1
            rel = {n: float((g.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30)
                   for n, g, w in zip(("y",) + names, (got_y,) + got,
                                      (want_y,) + want)}
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ep_ms = time_ms(torch, lambda: run(Collectives(group)), 5)
            host_ms = time_ms(torch, lambda: run(None), 5)
            row = {"phase": "ep_train", "check": "round", "arch": cfg.name,
                   "card": card, "dtype": dtype, "T": T, "E":
                       c.n_experts, "top_k": c.top_k, "capacity":
                       M.capacity(T, c.n_experts, c.top_k,
                                  c.moe_capacity_factor),
                   "world_size": dist.get_world_size(),
                   "backend": dist.get_backend(),
                   "max_err_over_max": rel, "tol": tol,
                   "launches_per_round": {k: launches[k] for k in
                                          ("moe_gmm", "moe_gmm_bwd")},
                   "ep_collectives_per_round": ep.counts,
                   "fwd_bwd_ms_ep_round": ep_ms,
                   "fwd_bwd_ms_moe_apply": host_ms}
            emit(row)
            rows.append(row)
            del want, got, want_y, got_y, p, x, dout
            torch.cuda.empty_cache()
            if not finite or max(rel.values()) > tol or \
                    row["launches_per_round"] != {"moe_gmm": 1,
                                                  "moe_gmm_bwd": 1} or \
                    ep.counts != {k: 2 * v for k, v in one_way.items()}:
                raise AssertionError(f"ep_train round {dtype}: {row}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if not with_ranks:
        return rows

    ep_cfg = dataclasses.replace(cfg, expert_parallel=True, n_layers=layers)
    ample = cfg.n_experts / cfg.top_k
    one = {}
    for cf, steps in ((None, 2), (ample, 1)):
        torch.cuda.reset_peak_memory_stats()
        c = ep_cfg if cf is None else \
            dataclasses.replace(ep_cfg, moe_capacity_factor=cf)
        one[cf] = tp_steps(torch, *tp_step_setup(
            torch, c, None, seq_len=1024, global_batch=8, microbatches=2,
            lr=1e-4), steps)
        gc.collect()
        torch.cuda.empty_cache()
    plan = {"kind": "ep", "dev": "cuda", "smoke": False,
            "cases": (("lc", None, 2), ("afe", None, 2), ("lc", ample, 1)),
            "bf16": (cfg.name, 1024, 8, 2), "layers": layers}
    local = dataclasses.replace(ep_cfg, n_experts=cfg.n_experts // 2)
    expect = expected_launches(local, 1024, 2)
    ep_expect = ep_expected_collectives(ep_cfg, 2)
    bad = []
    # (b) on (expert 2, data 1), then (c) one lc case on (expert 2, data 2)
    for data, check, cases in ((1, "bf16", plan["cases"]),
                               (2, "bf16_data2", (("lc", None, 2),))):
        got = tp_spawn(dict(plan, world=2 * data, data=data, cases=cases))
        for i, (policy, cf, steps) in enumerate(cases):
            data_expect = expected_collectives(cfg, policy, 2,
                                               StepConfig().n_buckets)
            if data > 1:
                # fault N's repair: the EP round all-gathers the data
                # ranks' token rows once per MoE layer and forward, the
                # remat recompute's included
                data_expect["all_gather"] += 2 * 2 * layers
            ref = one[cf]
            for r in range(2 * data):
                b = got[r][i]
                row = {"phase": "ep_train", "check": check, "rank": r,
                       "card": card, "arch": cfg.name, "layers": layers,
                       "mesh": f"expert 2, data {data}, model 1",
                       "backend": "gloo",
                       "policy": policy, "seq_len": 1024, "global_batch": 8,
                       "microbatches": 2, "capacity_factor":
                           cf or cfg.moe_capacity_factor,
                       "capacity": M.capacity(4096, cfg.n_experts,
                                              cfg.top_k,
                                              cf or cfg.moe_capacity_factor),
                       **b, "one_process_losses": ref["losses"],
                       "one_process_grad_norms": ref["grad_norms"],
                       "one_process_step_ms": ref["step_ms"],
                       "one_process_max_memory_allocated_gb":
                           ref["max_memory_allocated_gb"],
                       "expected_launches_per_step": expect,
                       "expected_ep_collectives_per_step": ep_expect,
                       "expected_collectives_per_step": data_expect}
                emit(row)
                rows.append(row)
                # the losses always; the gradient norms where capacity is
                # ample, since under pressure the EP round admits per lane
                # and per local expert what the single-host dispatch
                # admits (and re-routes) per expert over all tokens, as
                # the reference's does
                # on a data axis of 2 each data rank's loss is its rows'
                # mean: the mean over the ranks is the batch's
                losses = [sum(got[k][i]["losses"][t] for k in got) / len(got)
                          for t in range(steps)] if data > 1 else b["losses"]
                gated = list(zip(losses, ref["losses"]))
                if cf is not None:
                    gated += list(zip(b["grad_norms"], ref["grad_norms"]))
                for x, y in gated:
                    if not math.isfinite(x) or abs(x - y) > 2e-2 * abs(y):
                        bad.append(f"data {data} {policy} cf {cf} rank {r}: "
                                   f"{x} against {y}")
                if sum(b["skipped"]) \
                        or b["local_experts"] != local.n_experts \
                        or any(n != expect for n in b["launches"]) \
                        or any(n != ep_expect for n in b["ep_collectives"]) \
                        or any(n != data_expect for n in b["collectives"]):
                    bad.append(f"data {data} {policy} rank {r}: skipped "
                               f"{b['skipped']}, launches {b['launches']}, "
                               f"ep collectives {b['ep_collectives']}, "
                               f"collectives {b['collectives']}")
    if bad:
        raise AssertionError(f"ep_train: {bad}")
    return rows


# ---------------------------------------------------------------------------
# Phase 21: tensor-parallel serving
# ---------------------------------------------------------------------------


def teacher_forced_decode(torch, cfg, steps: int, *, mesh=None, cut=None,
                          tp=None, ep=None):
    """``cfg``'s weights and 2 rows of ``steps`` tokens from ``SEED``, the
    tokens fed one by one through ``decode_step``; each step's logits on
    the host, ``(steps, 2, V)``.  On ``mesh`` the weights are this rank's
    compute shards (``cut``: the ``(rank, size, axis)`` of
    ``tp_local_params``), the cache is the rank's and ``V`` its vocab
    shard; ``tp`` / ``ep`` the model and expert axes' groups."""
    from repro_torch.distributed.sharding import tp_local_params
    from repro_torch.models import model as TM

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = TM.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, steps), generator=gen,
                         device=dev)
    if mesh is not None:
        params = tp_local_params(params, cfg, *cut)
    cache = TM.init_cache(cfg, 2, steps, device=dev, mesh=mesh)
    out = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = TM.decode_step(params, cfg, cache, {
                "tokens": toks[:, t:t + 1],
                "cache_index": torch.tensor(t, device=dev)}, tp=tp, ep=ep)
            out.append(lg.float().cpu())
    return torch.stack(out)


def prefill_config(cfg):
    """:func:`chunked_prefill`'s config: ``cfg`` in fp32 at 2 layers,
    capacity factor E / top_k (no token dropped whatever shares a
    launch)."""
    return dataclasses.replace(cfg, dtype="float32", n_layers=2,
                               moe_capacity_factor=cfg.n_experts /
                               cfg.top_k)


def chunked_prefill(torch, cfg, *, mesh=None, cut=None, tp=None,
                    ep=None) -> dict:
    """``cfg`` from ``SEED`` under deterministic algorithms: a 48-token
    prompt (row 0; row 1 inert) prefilled through a ``(2, 64)`` buffer
    whole, in 32 + 16 and in 3 × 16, then one decode step.  ``delta``:
    the largest |Δ| of any chunking's cache or logits against the whole
    prefill's; ``cache`` / ``logits``: the whole prefill's, as numpy (on
    ``mesh`` this rank's cache and vocab shard; ``cut``, ``tp`` and
    ``ep`` as in :func:`teacher_forced_decode`)."""
    from repro_torch.device import parity_mode
    from repro_torch.distributed.sharding import tp_local_params
    from repro_torch.models import model as TM
    from repro_torch.tree import tree_leaves, tree_map

    dev = "cuda"
    parity_mode(deterministic=True)
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = TM.init_params(cfg, gen, device=dev)
        prompt = torch.randint(0, cfg.vocab, (49,), generator=gen,
                               device=dev)
        if mesh is not None:
            params = tp_local_params(params, cfg, *cut)
        runs = []
        with torch.no_grad():
            for sizes in ((48,), (32, 16), (16, 16, 16)):
                cache = TM.init_cache(cfg, 2, 64, device=dev, mesh=mesh)
                pos = 0
                for n in sizes:
                    buf = torch.zeros((2, 64), dtype=torch.long,
                                      device=dev)
                    buf[0, :n] = prompt[pos:pos + n]
                    TM.prefill_step(params, cfg, cache, {
                        "tokens": buf,
                        "cache_index": torch.tensor([pos, 0], device=dev),
                        "count": torch.tensor([n, 0], device=dev)},
                        tp=tp, ep=ep)
                    pos += n
                lg, _ = TM.decode_step(params, cfg, cache, {
                    "tokens": prompt[48:].expand(2, 1),
                    "cache_index": torch.tensor([48, 0], device=dev)},
                    tp=tp, ep=ep)
                runs.append((cache, lg))
    finally:
        parity_mode(deterministic=False)
    flat = [tree_leaves(c) + [lg] for c, lg in runs]
    # numpy: a tensor on the queue would travel as a file descriptor that
    # dies with the process that sent it
    return {"delta": max(float((a.float() - b.float()).abs().max())
                         for run in flat[1:] for a, b in zip(run, flat[0])),
            "cache": tree_map(lambda t: t.float().cpu().numpy(), runs[0][0]),
            "logits": runs[0][1].float().cpu().numpy()}


def tp_serve_rank_run(torch, rank: int, plan: dict) -> dict:
    """One model rank of :func:`phase_tp_serve` (b) and (c) on a ``(data
    1, model 2)`` mesh: fp32 teacher-forced decodes (this rank's vocab
    shard of each step's logits), chunked against whole prefill, then the
    bf16 closed batch through the ``ContinuousBatcher`` with this rank's
    shards: tokens, per-step ms, kernel and model launches, both axes'
    collectives, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.comm import Collectives
    from repro_torch.distributed.sharding import (
        tp_local_config, tp_local_params)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.serve import batcher as SB

    dev = "cuda"
    mesh = make_test_mesh(data=1, model=2, device_type="cpu")
    tpc = Collectives(mesh.get_group("model"))
    out = {"decode": [], "seconds": {}}
    t0 = time.perf_counter()
    for arch, steps in plan["decode"]:
        c = dataclasses.replace(get_config(arch), dtype="float32")
        out["decode"].append(teacher_forced_decode(
            torch, c, steps, mesh=mesh, cut=(rank, 2, "model"),
            tp=tpc).numpy())
    out["seconds"]["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["prefill"] = chunked_prefill(torch, prefill_config(get_config(
        plan["prefill"])), mesh=mesh, cut=(rank, 2, "model"), tp=tpc)
    out["seconds"]["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = get_config(plan["serve"])
    params = tp_local_params(TM.init_params(c, torch.Generator(
        device=dev).manual_seed(SEED), device=dev), c, rank, 2)
    reqs = closed_batch(c)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = SB.ContinuousBatcher(c, params, n_slots=8, cache_len=512,
                             policy="dlbc", prefill_chunk=32, device=dev,
                             mesh=mesh)
    out["seconds"]["serve_setup"] = time.perf_counter() - t0
    step_ms = []
    t0 = time.perf_counter()
    counts = counted_serve(torch, tp_local_config(c, 2), lambda:
                           step_ms.extend(drive_batcher(torch, b, reqs)))
    out["serve"] = {
        "tokens": [r.tokens[len(r.prompt):] for r in reqs],
        "finished": sum(r.done_step is not None for r in reqs),
        "wall_s": time.perf_counter() - t0, "step_ms": step_ms,
        "tp_collectives": b.tp.counts, "dp_collectives": b.dp.counts,
        "local_experts": int(params["layers"]["moe"]["w1"].shape[-3]),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **counts}
    return out


def tp_serve_one_rank(torch, cfg, card: str, one: dict) -> dict:
    """(a) of :func:`phase_tp_serve`: the closed batch on a one-rank NCCL
    group's ``(data 1, model 1)`` mesh, from the weights of
    :func:`phase_serve`'s batcher run (``one``, its row): the tokens must
    be bitwise that run's (each collective of one rank is a copy), the
    collectives exact."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.serve import batcher as SB

    store = nccl_world_of_one(torch)
    try:
        mesh = make_test_mesh(data=1, model=1)
        params = TM.init_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(SEED), device="cuda")
        reqs = closed_batch(cfg)
        b = SB.ContinuousBatcher(cfg, params, n_slots=8, cache_len=512,
                                 policy="dlbc", prefill_chunk=32,
                                 device="cuda", mesh=mesh)
        top = record_top_logits(torch, b)
        step_ms = []
        t0 = time.perf_counter()
        counts = counted_serve(torch, cfg, lambda: step_ms.extend(
            drive_batcher(torch, b, reqs)))
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    tokens = [r.tokens[len(r.prompt):] for r in reqs]
    top = {k: (v.tolist(), i.tolist()) for k, (v, i) in
           ((k, (v.float().cpu(), i.cpu())) for k, (v, i) in top.items())}
    per = 1 + 2 * cfg.n_layers
    n_pre, n_dec = counts["prefill_rounds"], counts["decode_steps"]
    zero = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0)
    expect = {"tp": dict(zero, all_reduce=per * (n_pre + n_dec),
                         all_gather=n_dec),
              "dp": dict(zero, all_gather=n_dec)}
    row = {"phase": "tp_serve", "check": "one_rank", "arch": cfg.name,
           "dtype": cfg.dtype, "card": card, "backend": "nccl",
           "mesh": "data 1, model 1",
           "tokens_bitwise_equal_serve": tokens == one["tokens"],
           "finished": sum(r.done_step is not None for r in reqs),
           "steps": len(step_ms),
           "tokens_per_s": sum(map(len, tokens)) / wall,
           "p50_step_ms": float(np.percentile(step_ms, 50)),
           "p99_step_ms": float(np.percentile(step_ms, 99)),
           "serve_p50_step_ms": one["p50_step_ms"],
           "tp_collectives": b.tp.counts, "dp_collectives": b.dp.counts,
           "expected_collectives": expect, **counts}
    emit(row)
    if tokens != one["tokens"] or row["finished"] != 16:
        raise AssertionError("tp_serve (a): the one-rank mesh's tokens "
                             "differ from the mesh-free run's")
    if b.tp.counts != expect["tp"] or b.dp.counts != expect["dp"]:
        raise AssertionError(f"tp_serve (a): collectives {row}")
    return dict(row, tokens=tokens, top=top)


def record_top_logits(torch, b, k: int = 5) -> dict:
    """Wrap the batcher ``b``'s ``_next_tokens``: for every request token
    it picks, ``(rid, j)`` (the request's ``j``-th generated token) →
    the ``k`` largest logits over the real vocab and their ids, kept on
    the card (no copy to the host inside the run)."""
    top, real = {}, b._next_tokens

    def next_tokens(logits):
        v, ids = torch.topk(logits[:, :b.cfg.vocab].float(), k, dim=-1)
        for i, r in enumerate(b.slot_req):
            if r is not None and i not in b._prefilling:
                top[(r.rid, len(r.tokens) - len(r.prompt))] = (v[i], ids[i])
        return real(logits)

    b._next_tokens = next_tokens
    return top


def first_difference_margins(tokens: list, one: dict) -> dict:
    """Where each request's ``tokens`` first differ from the one-rank
    run's (``one``: :func:`tp_serve_one_rank`'s row, its ``top``
    logits): that run's top-1 minus top-2 logit there and its top-1 minus
    the logit of the token taken instead (None when that token is not in
    its top 5); beside them the top-1 minus top-2 margin at every
    generated token of the one-rank run (median, 10th percentile)."""
    import numpy as np

    firsts = []
    for rid, (x, y) in enumerate(zip(tokens, one["tokens"])):
        j = next((j for j, (a, c) in enumerate(zip(x, y)) if a != c), None)
        if j is None:
            continue
        v, ids = one["top"][(rid, j)]
        firsts.append({"request": rid, "token": j,
                       "top1_minus_top2": v[0] - v[1],
                       "top1_minus_taken": v[0] - v[ids.index(x[j])]
                       if x[j] in ids else None})
    every = [v[0] - v[1] for v, _ in one["top"].values()]
    return {"first_differences": firsts,
            "margin_median_all_tokens": float(np.median(every)),
            "margin_p10_all_tokens": float(np.percentile(every, 10))}


def phase_tp_serve(torch, cfg, hymba, card: str, one: dict) -> dict:
    """Tensor-parallel serving (``decode_step``, span prefill and the
    ``ContinuousBatcher`` on a mesh); ``one``: :func:`phase_serve`'s row,
    the mesh-free batcher's run.

    (a) :func:`tp_serve_one_rank`: full-width bf16 ``cfg`` (granite) on
    one NCCL rank, ``phase_serve``'s closed batch; tokens bitwise equal to
    the mesh-free run's.
    (b) Two processes on the one card over gloo at ``(data 1, model 2)``
    (:func:`tp_spawn`, a plan of kind ``"serve"``): fp32 (TF32 off)
    teacher-forced decode of full-width ``cfg`` and ``hymba`` (its 25
    heads whole on both ranks, ``d_inner`` split), 16 steps, each step's
    logits gathered over the vocab shards within 1e-4 (max |Δ| / max
    |ref|) of the one-process port's (run here first, same seeds); fp32
    chunked prefill of full-width ``cfg`` at 2 layers (capacity factor E /
    top_k: no token dropped whatever shares a launch) equal to whole
    prefill on each rank, max |Δ| 0.0, and the whole prefill's cache and
    next logits, gathered over the ranks, within 1e-4 (max |Δ| / max
    |ref|, per leaf) of one process's (where chunked == whole too).
    (c) The same two ranks serve the closed batch in bf16 with their
    shards (E 16 per rank): 16/16 finished, both ranks' tokens identical,
    ``moe_gmm`` exactly once per layer per model launch, at one ``(E, C)``
    per kind of launch (those of the ``kernels`` rows), and each axis's
    collectives exact per prefill round and decode step; step p50 / p99,
    tokens/s, peak memory per rank against ``one``'s, and the share of
    generated tokens equal to ``one``'s (not gated: bf16 partial sums
    added in another order can flip a near tie), with (a)'s logit
    margins where each request first differs
    (:func:`first_difference_margins`).  Step times include gloo's host
    staging of every all-reduce."""
    import gc

    import numpy as np

    from repro_torch.distributed.sharding import (
        tp_assemble_cache, tp_local_config)
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    one_rank = tp_serve_one_rank(torch, cfg, card, one)
    seconds = {"one_rank": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = [dataclasses.replace(c, dtype="float32") for c in (cfg, hymba)]
    refs = [teacher_forced_decode(torch, c, 16) for c in f32]
    pre_cfg = prefill_config(cfg)
    pre_ref = chunked_prefill(torch, pre_cfg)
    seconds["one_process_decode_prefill"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = tp_spawn({"kind": "serve", "dev": "cuda",
                    "decode": [(c.name, 16) for c in f32],
                    "prefill": cfg.name, "serve": cfg.name})
    seconds["ranks"] = time.perf_counter() - t0
    emit({"phase": "tp_serve", "check": "seconds", **seconds,
          "rank_seconds": [got[r]["seconds"] for r in range(2)]})
    rows, bad = [], []
    for i, c in enumerate(f32):
        whole = torch.cat([torch.from_numpy(got[r]["decode"][i])
                           for r in range(2)], -1)
        ref = refs[i]
        err = [float((whole[t] - ref[t]).abs().max()) /
               float(ref[t].abs().max()) for t in range(ref.shape[0])]
        row = {"phase": "tp_serve", "check": "fp32_decode", "arch": c.name,
               "card": card, "mesh": "data 1, model 2", "backend": "gloo",
               "steps": ref.shape[0], "shape": list(whole.shape),
               "max_err_over_max_per_step": err,
               "argmax_equal": bool(torch.equal(whole.argmax(-1),
                                                ref.argmax(-1)))}
        emit(row)
        rows.append(row)
        if whole.shape != ref.shape or max(err) > 1e-4:
            bad.append(f"fp32 decode {c.name}: {max(err)}")

    def paths(t, at=""):
        """The leaves' paths, in :func:`tree_leaves`' order."""
        return [p for k in sorted(t) for p in paths(t[k], f"{at}/{k}")] \
            if isinstance(t, dict) else [at]

    delta = [got[r]["prefill"]["delta"] for r in range(2)]
    pieces = [got[r]["prefill"] for r in range(2)]
    whole = tree_leaves(tp_assemble_cache(
        [[tree_map(torch.from_numpy, p["cache"]) for p in pieces]],
        pre_cfg)) + [torch.cat([torch.from_numpy(p["logits"])
                                for p in pieces], -1)]
    ref = tree_leaves(tree_map(torch.from_numpy, pre_ref["cache"])) + [
        torch.from_numpy(pre_ref["logits"])]
    err = [float((a - c).abs().max()) / float(c.abs().max())
           if a.shape == c.shape else float("inf")
           for a, c in zip(whole, ref)]
    row = {"phase": "tp_serve", "check": "chunked_prefill", "arch": cfg.name,
           "card": card, "dtype": "float32", "mesh": "data 1, model 2",
           "layers": pre_cfg.n_layers,
           "chunkings": [[48], [32, 16], [16, 16, 16]],
           "chunked_vs_whole_max_abs_diff": delta,
           "one_process_chunked_vs_whole_max_abs_diff": pre_ref["delta"],
           "whole_vs_one_process_max_err_over_max_per_leaf": err,
           "leaves": [f"cache{k}" for k in paths(pre_ref["cache"])] +
                     ["next logits"]}
    emit(row)
    rows.append(row)
    if any(d != 0.0 for d in delta + [pre_ref["delta"]]):
        bad.append(f"chunked prefill != whole: ranks {delta}, one process "
                   f"{pre_ref['delta']}")
    if len(whole) != len(ref) or max(err) > 1e-4:
        bad.append(f"prefill on the ranks vs one process: {err}")
    local = tp_local_config(cfg, 2)
    # per decode step (S 1, whole activations) the embedding's and every
    # layer's two all-reduces; per prefill round (C 32, sequence-parallel)
    # the embedding's and every layer's two reduce-scatters and the two
    # normed inputs' and the head input's all-gathers
    per = 1 + 2 * cfg.n_layers
    zero = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0)
    want = one["tokens"]
    for r in range(2):
        srv = got[r]["serve"]
        n_pre, n_dec = srv["prefill_rounds"], srv["decode_steps"]
        gen = sum(len(t) for t in srv["tokens"])
        agree = sum(a == b for x, y in zip(srv["tokens"], want)
                    for a, b in zip(x, y))
        shapes = srv["moe_gmm_shapes"]
        row = {"phase": "tp_serve", "check": "serve_bf16", "rank": r,
               "card": card, "arch": cfg.name, "dtype": cfg.dtype,
               "mesh": "data 1, model 2", "backend": "gloo",
               "local_experts": srv["local_experts"],
               "finished": srv["finished"], "steps": len(srv["step_ms"]),
               "generated_tokens": gen, "tokens_per_s": gen / srv["wall_s"],
               "p50_step_ms": float(np.percentile(srv["step_ms"], 50)),
               "p99_step_ms": float(np.percentile(srv["step_ms"], 99)),
               "max_memory_allocated_gb": srv["max_memory_allocated_gb"],
               "one_process_max_memory_allocated_gb":
                   one["max_memory_allocated_gb"],
               "one_process_p50_step_ms": one["p50_step_ms"],
               "one_process_tokens_per_s": one["tokens_per_s"],
               "tokens_equal_one_process_share": agree / max(gen, 1),
               "tokens_equal_other_rank":
                   srv["tokens"] == got[1 - r]["serve"]["tokens"],
               "near_ties": first_difference_margins(srv["tokens"],
                                                     one_rank),
               "launches": srv["launches"],
               "moe_gmm_by_call": srv["moe_gmm_by_call"],
               "moe_gmm_shapes": shapes,
               "prefill_rounds": n_pre, "decode_steps": n_dec,
               "tp_collectives": srv["tp_collectives"],
               "dp_collectives": srv["dp_collectives"]}
        emit(row)
        rows.append(row)
        if srv["finished"] != 16 or gen != 16 * 32 or \
                not row["tokens_equal_other_rank"] or \
                srv["local_experts"] != local.n_experts:
            bad.append(f"serve rank {r}: {srv['finished']}/16 finished, "
                       f"{gen} tokens, ranks alike "
                       f"{row['tokens_equal_other_rank']}")
        if srv["tp_collectives"] != dict(
                zero, all_reduce=per * n_dec, reduce_scatter=per * n_pre,
                all_gather=n_dec + per * n_pre) or \
                srv["dp_collectives"] != dict(zero, all_gather=n_dec):
            bad.append(f"serve rank {r}: collectives")
        if [len(shapes[k]) for k in ("prefill", "decode")] != [1, 1]:
            bad.append(f"serve rank {r}: moe_gmm shapes {shapes}")
    if bad:
        raise AssertionError(f"tp_serve: {bad}")
    return {"rows": rows, "serve": got[0]["serve"], "one_rank": one_rank}


# ---------------------------------------------------------------------------
# Phase 22: EP with a model axis, the reference's production layout
# ---------------------------------------------------------------------------

EP_TP_MESH = "expert 2, data 1, model 2"


def ep_tp_expected(cfg, microbatches: int) -> dict:
    """Per train step under ``remat`` on ``(expert 2, data 1, model 2)``,
    sequence-parallel: the model axis's collectives and the expert
    axis's, as without a model axis (:func:`ep_expected_collectives`).
    Model axis per microbatch, ``L`` layers: forward, the embedding's
    reduce-scatter, per layer the two normed inputs' all-gathers,
    attention's reduce-scatter and the EP round's lane all-reduce (its
    whole result leaves by a slice), the head input's all-gather and the
    cross entropy's three all-reduces; the recompute (on to the
    gate-combine's saved input, past the return exchange) re-issues the
    two all-gathers, attention's reduce-scatter and the lane all-reduce;
    backward, the slice's and attention's gradients all-gathered, the two
    gathered inputs' reduce-scattered, the packed tokens' all-reduced,
    and the embedding's all-gather and the head input's reduce-scatter:
    ``6L + 2`` all-gathers, ``4L + 2`` reduce-scatters, ``3L + 3``
    all-reduces.  Per step the norms' partial gradients summed and the
    gradient norm: two all-reduces."""
    L, M = cfg.n_layers, microbatches
    zero = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0)
    return {"tp": dict(zero, all_gather=M * (6 * L + 2),
                       reduce_scatter=M * (4 * L + 2),
                       all_reduce=M * (3 * L + 3) + 2),
            "ep": ep_expected_collectives(cfg, microbatches)}


def ep_tp_rank_run(torch, rank: int, plan: dict) -> dict:
    """One rank of :func:`phase_ep_tp` on an ``(expert 2, data 1, model
    2)`` mesh, with its expert rank's ``E/S`` experts × ``d_ff/m`` and its
    model rank's heads and vocab rows: (d) fp32 teacher-forced decode and
    chunked against whole prefill (``prefill_config``: 2 layers, capacity
    factor E / top_k), (b) the bf16 train steps of each case ``(policy,
    capacity factor or None for the config's, steps)``, (c) the closed
    batch through the ``ContinuousBatcher``."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.distributed.comm import Collectives
    from repro_torch.distributed.sharding import (
        tp_local_config, tp_local_params)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.serve import batcher as SB

    dev = "cuda"
    mesh = make_test_mesh(data=1, model=2, expert=2, device_type="cpu")
    ep = Collectives(mesh.get_group("expert"))
    tp = Collectives(mesh.get_group("model"))
    cut = ((ep.rank, tp.rank), (2, 2), ("expert", "model"))
    base = dataclasses.replace(get_config(plan["arch"]), expert_parallel=True)
    out = {"coords": [ep.rank, tp.rank], "seconds": {}}
    t0 = time.perf_counter()
    f32 = prefill_config(base)
    out["decode"] = teacher_forced_decode(
        torch, f32, 16, mesh=mesh, cut=cut, tp=tp, ep=ep).numpy()
    out["prefill"] = chunked_prefill(torch, f32, mesh=mesh, cut=cut, tp=tp,
                                     ep=ep)
    out["seconds"]["fp32"] = time.perf_counter() - t0
    S, B, mb = plan["bf16"]
    out["train"] = []
    t0 = time.perf_counter()
    for policy, cf, steps in plan["cases"]:
        cfg = base if cf is None else \
            dataclasses.replace(base, moe_capacity_factor=cf)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, p, o, batch = tp_step_setup(
            torch, cfg, mesh, seq_len=S, global_batch=B, microbatches=mb,
            lr=1e-4, dev=dev, policy=policy)
        res = tp_steps(torch, step, p, o, batch, steps, dev)
        res["local_w1"] = list(p["layers"]["moe"]["w1"].shape)
        out["train"].append(res)
        del step, p, o, batch
        gc.collect()
    out["seconds"]["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = tp_local_params(TM.init_params(base, torch.Generator(
        device=dev).manual_seed(SEED), device=dev), base, *cut)
    reqs = closed_batch(base)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = SB.ContinuousBatcher(base, params, n_slots=8, cache_len=512,
                             policy="dlbc", prefill_chunk=32, device=dev,
                             mesh=mesh)
    step_ms = []
    t1 = time.perf_counter()
    counts = counted_serve(torch, tp_local_config(base, 2, expert=2),
                           lambda: step_ms.extend(drive_batcher(
                               torch, b, reqs)))
    out["serve"] = {
        "tokens": [r.tokens[len(r.prompt):] for r in reqs],
        "finished": sum(r.done_step is not None for r in reqs),
        "wall_s": time.perf_counter() - t1, "step_ms": step_ms,
        "tp_collectives": b.tp.counts, "dp_collectives": b.dp.counts,
        "ep_collectives": b.ep.counts,
        "local_w1": list(params["layers"]["moe"]["w1"].shape),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **counts}
    out["seconds"]["serve"] = time.perf_counter() - t0
    return out


def phase_ep_tp(torch, cfg, card: str, one_rank: dict) -> dict:
    """EP with a model axis (the reference's ``(expert, data, model)``
    production layout): four processes on the one card over gloo at
    ``(expert 2, data 1, model 2)`` (:func:`tp_spawn`, a plan of kind
    ``"ep_tp"``), ``cfg`` (granite) at full width and depth with
    ``expert_parallel``: each rank computes with its expert rank's 16
    experts × 256 of their 512 d_ff columns, and its model rank's 8 heads
    (4 KV) and half of the vocab; the EP round runs inside the
    tensor-parallel region.  ``one_rank``: :func:`tp_serve_one_rank`'s
    row (the one-process closed batch, with its top logits).

    (d) fp32 (TF32 off), 2 layers, capacity factor E / top_k: 16
    teacher-forced decode steps, each step's logits gathered over the
    vocab shards within 2e-5 of max |ref| of one process's (run here
    first, same seeds), the expert ranks of each model rank alike; the
    chunked prefill equal to whole prefill on each rank (max |Δ| 0.0) and
    the whole prefill's cache and next logits, put together over the
    model ranks, within 2e-5 of max |ref| of one process's.
    (b) bf16, seq 1024, global batch 8 in 2 microbatches (C 1280 per
    round at the config's capacity): 2 AdamW steps each of ``lc`` and
    ``afe``, and one ``lc`` step at capacity factor E / top_k (C 4096):
    every step's loss within 2e-2 relative of the one-process steps (and
    at ample capacity the gradient norm), no skipped step, each rank's
    launches exactly ``expected_launches`` of the rank-local config, the
    data, model and expert axes' collectives exact; per-rank step ms and
    peak memory.
    (c) bf16, the closed batch (16 requests, 8 slots): 16/16 finished,
    the 4 ranks' tokens identical, ``moe_gmm`` once per layer per model
    launch at one ``(E, C)`` per kind of launch, each axis's collectives
    exact; step p50 / p99, tokens/s and peak memory per rank, the share
    of tokens equal to ``one_rank``'s and the logit margins where each
    request first differs (:func:`first_difference_margins`).

    Step times include gloo's host staging of every collective (nothing
    here measures NVLink)."""
    import gc

    import numpy as np

    from repro_torch.distributed.sharding import (
        tp_assemble_cache, tp_local_config)
    from repro_torch.train.train_step import StepConfig
    from repro_torch.tree import tree_leaves, tree_map

    ep_cfg = dataclasses.replace(cfg, expert_parallel=True)
    ample = cfg.n_experts / cfg.top_k
    S, B, mb = 1024, 8, 2
    cases = (("lc", None, 2), ("afe", None, 2), ("lc", ample, 1))
    t0 = time.perf_counter()
    f32 = prefill_config(ep_cfg)
    ref_dec = teacher_forced_decode(torch, f32, 16)
    ref_pre = chunked_prefill(torch, f32)
    one = {}
    for cf, steps in ((None, 2), (ample, 1)):
        torch.cuda.reset_peak_memory_stats()
        c = ep_cfg if cf is None else \
            dataclasses.replace(ep_cfg, moe_capacity_factor=cf)
        one[cf] = tp_steps(torch, *tp_step_setup(
            torch, c, None, seq_len=S, global_batch=B, microbatches=mb,
            lr=1e-4), steps)
        gc.collect()
        torch.cuda.empty_cache()
    seconds = {"one_process": time.perf_counter() - t0}
    t0 = time.perf_counter()
    got = tp_spawn({"kind": "ep_tp", "world": 4, "dev": "cuda",
                    "arch": cfg.name, "cases": cases, "bf16": (S, B, mb)})
    seconds["ranks"] = time.perf_counter() - t0
    emit({"phase": "ep_tp", "check": "seconds", **seconds,
          "rank_seconds": [got[r]["seconds"] for r in range(4)]})
    at = {tuple(got[r]["coords"]): got[r] for r in range(4)}
    if sorted(at) != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        raise AssertionError(f"ep_tp: rank coordinates {sorted(at)}")
    rows, bad = [], []
    base = {"phase": "ep_tp", "card": card, "arch": cfg.name,
            "mesh": EP_TP_MESH, "backend": "gloo"}

    # (d) fp32 decode and prefill against one process
    whole = torch.cat([torch.from_numpy(at[(0, r)]["decode"])
                       for r in range(2)], -1)
    err = [float((whole[t] - ref_dec[t]).abs().max()) /
           float(ref_dec[t].abs().max()) for t in range(ref_dec.shape[0])]
    alike = all(np.array_equal(at[(0, r)]["decode"], at[(1, r)]["decode"])
                for r in range(2))
    row = dict(base, check="fp32_decode", layers=f32.n_layers,
               capacity_factor=f32.moe_capacity_factor,
               steps=ref_dec.shape[0], shape=list(whole.shape),
               max_err_over_max_per_step=err,
               expert_ranks_alike=alike,
               argmax_equal=bool(torch.equal(whole.argmax(-1),
                                             ref_dec.argmax(-1))))
    emit(row)
    rows.append(row)
    if whole.shape != ref_dec.shape or max(err) > 2e-5 or not alike:
        bad.append(f"fp32 decode: {max(err)}, expert ranks alike {alike}")
    delta = [got[r]["prefill"]["delta"] for r in range(4)]
    pieces = [at[(0, r)]["prefill"] for r in range(2)]
    whole = tree_leaves(tp_assemble_cache(
        [[tree_map(torch.from_numpy, p["cache"]) for p in pieces]],
        f32)) + [torch.cat([torch.from_numpy(p["logits"])
                            for p in pieces], -1)]
    ref = tree_leaves(tree_map(torch.from_numpy, ref_pre["cache"])) + [
        torch.from_numpy(ref_pre["logits"])]
    err = [float((a - c).abs().max()) / float(c.abs().max())
           if a.shape == c.shape else float("inf")
           for a, c in zip(whole, ref)]
    row = dict(base, check="chunked_prefill", dtype="float32",
               layers=f32.n_layers,
               chunkings=[[48], [32, 16], [16, 16, 16]],
               chunked_vs_whole_max_abs_diff=delta,
               one_process_chunked_vs_whole_max_abs_diff=ref_pre["delta"],
               whole_vs_one_process_max_err_over_max_per_leaf=err)
    emit(row)
    rows.append(row)
    if any(d != 0.0 for d in delta + [ref_pre["delta"]]):
        bad.append(f"chunked prefill != whole: ranks {delta}, one process "
                   f"{ref_pre['delta']}")
    if len(whole) != len(ref) or max(err) > 2e-5:
        bad.append(f"prefill on the ranks vs one process: {err}")

    # (b) bf16 train steps
    local = tp_local_config(ep_cfg, 2, expert=2)
    local_w1 = [cfg.n_layers, cfg.n_experts // 2, cfg.d_model,
                cfg.d_ff // 2]
    expect = expected_launches(local, S, mb)
    axes = ep_tp_expected(cfg, mb)
    for i, (policy, cf, steps) in enumerate(cases):
        data_expect = expected_collectives(cfg, policy, mb,
                                           StepConfig().n_buckets)
        ref = one[cf]
        for r in range(4):
            b = got[r]["train"][i]
            row = dict(base, check="bf16_train", rank=r,
                       coords=got[r]["coords"], policy=policy, seq_len=S,
                       global_batch=B, microbatches=mb,
                       capacity_factor=cf or cfg.moe_capacity_factor,
                       **b, one_process_losses=ref["losses"],
                       one_process_grad_norms=ref["grad_norms"],
                       one_process_step_ms=ref["step_ms"],
                       one_process_max_memory_allocated_gb=ref[
                           "max_memory_allocated_gb"],
                       expected_launches_per_step=expect,
                       expected_tp_collectives_per_step=axes["tp"],
                       expected_ep_collectives_per_step=axes["ep"],
                       expected_collectives_per_step=data_expect)
            emit(row)
            rows.append(row)
            gated = list(zip(b["losses"], ref["losses"]))
            if cf is not None:
                gated += list(zip(b["grad_norms"], ref["grad_norms"]))
            for x, y in gated:
                if not math.isfinite(x) or abs(x - y) > 2e-2 * abs(y):
                    bad.append(f"{policy} cf {cf} rank {r}: {x} against "
                               f"{y}")
            if sum(b["skipped"]) or b["local_w1"] != local_w1 \
                    or any(n != expect for n in b["launches"]) \
                    or any(n != axes["tp"] for n in b["tp_collectives"]) \
                    or any(n != axes["ep"] for n in b["ep_collectives"]) \
                    or any(n != data_expect for n in b["collectives"]):
                bad.append(f"{policy} rank {r}: skipped {b['skipped']}, "
                           f"w1 {b['local_w1']}, launches {b['launches']}, "
                           f"collectives {b['collectives']} / "
                           f"{b['tp_collectives']} / {b['ep_collectives']}")

    # (c) the closed batch: per decode step (S 1) the embedding's and every
    # layer's two all-reduces (attention's, the round's lane reduce); per
    # prefill round (C 32, sequence-parallel) the embedding's and
    # attention's reduce-scatters, the lane all-reduces, the two normed
    # inputs' and the head input's all-gathers
    L = cfg.n_layers
    per = 1 + 2 * L
    zero = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0)
    want = one_rank["tokens"]
    for r in range(4):
        srv = got[r]["serve"]
        n_pre, n_dec = srv["prefill_rounds"], srv["decode_steps"]
        n = n_pre + n_dec
        gen = sum(len(t) for t in srv["tokens"])
        agree = sum(a == c for x, y in zip(srv["tokens"], want)
                    for a, c in zip(x, y))
        shapes = srv["moe_gmm_shapes"]
        alike = all(srv["tokens"] == got[k]["serve"]["tokens"]
                    for k in range(4))
        row = dict(base, check="serve_bf16", rank=r,
                   coords=got[r]["coords"], dtype=cfg.dtype,
                   local_w1=srv["local_w1"], finished=srv["finished"],
                   steps=len(srv["step_ms"]), generated_tokens=gen,
                   tokens_per_s=gen / srv["wall_s"],
                   p50_step_ms=float(np.percentile(srv["step_ms"], 50)),
                   p99_step_ms=float(np.percentile(srv["step_ms"], 99)),
                   max_memory_allocated_gb=srv["max_memory_allocated_gb"],
                   one_process_p50_step_ms=one_rank["p50_step_ms"],
                   one_process_tokens_per_s=one_rank["tokens_per_s"],
                   tokens_equal_one_process_share=agree / max(gen, 1),
                   tokens_equal_other_ranks=alike,
                   near_ties=first_difference_margins(srv["tokens"],
                                                      one_rank),
                   launches=srv["launches"],
                   moe_gmm_by_call=srv["moe_gmm_by_call"],
                   moe_gmm_shapes=shapes, prefill_rounds=n_pre,
                   decode_steps=n_dec,
                   tp_collectives=srv["tp_collectives"],
                   dp_collectives=srv["dp_collectives"],
                   ep_collectives=srv["ep_collectives"])
        emit(row)
        rows.append(row)
        if srv["finished"] != 16 or gen != 16 * 32 or not alike or \
                srv["local_w1"] != local_w1:
            bad.append(f"serve rank {r}: {srv['finished']}/16 finished, "
                       f"{gen} tokens, ranks alike {alike}")
        if srv["tp_collectives"] != dict(
                zero, all_reduce=per * n_dec + L * n_pre,
                reduce_scatter=(L + 1) * n_pre,
                all_gather=n_dec + (2 * L + 1) * n_pre) or \
                srv["dp_collectives"] != dict(zero, all_gather=n_dec) or \
                srv["ep_collectives"] != dict(
                    zero, all_to_all=2 * cfg.n_layers * n,
                    all_gather=cfg.n_layers * n):
            bad.append(f"serve rank {r}: collectives")
        if [len(shapes[k]) for k in ("prefill", "decode")] != [1, 1]:
            bad.append(f"serve rank {r}: moe_gmm shapes {shapes}")
    if bad:
        raise AssertionError(f"ep_tp: {bad}")
    return {"rows": rows, "train": at[(0, 0)]["train"],
            "serve": at[(0, 0)]["serve"]}


# ---------------------------------------------------------------------------
# Phase 23: a multi-pod mesh with a model axis
# ---------------------------------------------------------------------------

MULTI_POD_MESH = "pod 2, data 2, model 2"


def multi_pod_rank_run(torch, rank: int, plan: dict) -> dict:
    """One rank of :func:`phase_multi_pod` on a ``(pod 2, data 2, model
    2)`` mesh: the ranks of its data-parallel group (``mesh_group`` over
    ``("pod", "data")``, the 4 ranks that share its model coordinate),
    then one step of each of ``plan["policies"]`` (:func:`tp_steps`)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.comm import mesh_group
    from repro_torch.launch.mesh import make_test_mesh

    dev = plan["dev"]
    mesh = make_test_mesh(pod=2, data=2, model=2, device_type="cpu")
    cfg = dataclasses.replace(get_config(plan["arch"], smoke=plan["smoke"]),
                              n_layers=plan["layers"])
    S, B, mb = plan["bf16"]
    out = {"data_group": dist.get_process_group_ranks(
        mesh_group(mesh, ("pod", "data")))}
    for policy in plan["policies"]:
        step, p, o, batch = tp_step_setup(
            torch, cfg, mesh, seq_len=S, global_batch=B, microbatches=mb,
            lr=1e-4, dev=dev, policy=policy)
        out[policy] = tp_steps(torch, step, p, o, batch, 1, dev)
        del step, p, o, batch
    return out


def phase_multi_pod(torch, cfg, card: str, layers: int = 2) -> list:
    """Fault K's layout: eight processes on the one card over gloo at
    ``(pod 2, data 2, model 2)`` (:func:`tp_spawn`, a plan of kind
    ``"multi_pod"``), ``cfg`` (granite) at full width, ``layers`` of its
    24 layers, bf16, seq 1024, global batch 8 in 2 microbatches (one row
    per data rank and microbatch), sequence-parallel over the model
    ranks: one ``afe`` and one ``lc`` step from the same weights and
    batch as one process's (run here first).  Gates: each rank's data
    group the 4 ranks of its model coordinate; the mean over the data
    ranks of the loss (each rank's is over its rows) within 2e-2 relative
    of the one-process step's, and the gradient norm within 2e-3 (expert
    capacity and slot positions over the whole microbatch, as one process
    sizes them: ROADMAP fault M, repaired); each rank's launches exactly
    ``expected_launches`` of the rank-local config; the data axes'
    collectives (over the 4-rank group) those of the policy over one
    model rank's tree with the MoE layers' count all-gathers, the model
    axis's :func:`tp_expected`, none on an expert axis."""
    from repro_torch.distributed.sharding import tp_local_config
    from repro_torch.train.train_step import StepConfig

    c = dataclasses.replace(cfg, n_layers=layers)
    S, B, mb = 1024, 8, 2
    policies = ("afe", "lc")
    t0 = time.perf_counter()
    one = {pol: tp_steps(torch, *tp_step_setup(
        torch, c, None, seq_len=S, global_batch=B, microbatches=mb, lr=1e-4,
        policy=pol), 1) for pol in policies}
    seconds = {"one_process": time.perf_counter() - t0}
    t0 = time.perf_counter()
    got = tp_spawn({"kind": "multi_pod", "world": 8, "dev": "cuda",
                    "smoke": False, "arch": cfg.name, "layers": layers,
                    "policies": policies, "bf16": (S, B, mb)})
    seconds["ranks"] = time.perf_counter() - t0
    emit({"phase": "multi_pod", "check": "seconds", **seconds})
    expect = expected_launches(tp_local_config(c, 2), S, mb)
    tp_want = tp_expected(c, mb)
    rows, bad = [], []
    for r in range(8):
        want = [r % 2 + 2 * k for k in range(4)]
        if got[r]["data_group"] != want:
            bad.append(f"rank {r}: data group {got[r]['data_group']}")
    for policy in policies:
        data_want = expected_collectives(c, policy, mb,
                                         StepConfig().n_buckets, model=2,
                                         data=4)
        losses = [got[r][policy]["losses"][0] for r in range(8)]
        loss = sum(losses[0::2]) / 4        # model rank 0 of each data rank
        ref = one[policy]
        for r in range(8):
            b = got[r][policy]
            row = {"phase": "multi_pod", "check": "bf16_step", "rank": r,
                   "card": card, "arch": cfg.name, "layers": layers,
                   "mesh": MULTI_POD_MESH, "backend": "gloo",
                   "policy": policy, "seq_len": S, "global_batch": B,
                   "microbatches": mb, "data_group": got[r]["data_group"],
                   **b, "mean_loss_over_data_ranks": loss,
                   "one_process_losses": ref["losses"],
                   "one_process_grad_norms": ref["grad_norms"],
                   "one_process_step_ms": ref["step_ms"],
                   "expected_launches_per_step": expect,
                   "expected_collectives_per_step": data_want,
                   "expected_tp_collectives_per_step": tp_want}
            emit(row)
            rows.append(row)
            x, y = loss, ref["losses"][0]
            if not math.isfinite(x) or abs(x - y) > 2e-2 * abs(y):
                bad.append(f"{policy} rank {r}: {x} against {y}")
            gn, g1 = b["grad_norms"][0], ref["grad_norms"][0]
            if not math.isfinite(gn) or abs(gn - g1) > 2e-3 * abs(g1):
                bad.append(f"{policy} rank {r}: gradient norm {gn} against "
                           f"{g1}")
            if b["skipped"] != [0] or b["launches"] != [expect] or \
                    b["collectives"] != [data_want] or \
                    b["tp_collectives"] != [tp_want] or \
                    b["ep_collectives"] != [{}]:
                bad.append(f"{policy} rank {r}: skipped {b['skipped']}, "
                           f"launches {b['launches']}, collectives "
                           f"{b['collectives']} / {b['tp_collectives']}")
    if bad:
        raise AssertionError(f"multi_pod: {bad}")
    return rows


# ---------------------------------------------------------------------------
# Phase 24: context-parallel decode caches
# ---------------------------------------------------------------------------


def cp_expected(cfg, m: int, heads: bool) -> tuple:
    """The context group's and the model axis's collectives per decode
    step of a dense, moe or hybrid config on a context-parallel cache: per
    attention layer two all-reduces on the context group (the scores'
    maximum, then the sums and values); on ``m`` model ranks (None at 1)
    the embedding's all-reduce, per layer attention's ``wo`` where the
    heads split, the mamba mixer's two and the FFN's, and where ``heads``
    (the time axis over the model ranks and the heads split) one
    all-gather of the query and new K/V heads per layer."""
    from repro_torch.distributed.sharding import attn_split

    L = cfg.n_layers
    zero = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0)
    if m == 1:
        return zero | {"all_reduce": 2 * L}, None
    per = (1 if attn_split(cfg, m) else 0) + 1 + \
        (2 if cfg.family == "hybrid" else 0)
    return zero | {"all_reduce": 2 * L}, zero | {
        "all_reduce": 1 + L * per, "all_gather": L if heads else 0}


def cp_decode_rank_run(torch, rank: int, plan: dict) -> dict:
    """One rank of :func:`phase_cp_decode` on a ``(data, model)`` mesh of
    ``plan["mesh"]``: for each case, the whole cache from the seed, this
    rank's block of it (``cp_local_cache``), the decode steps on the block
    over the context group (launches counted), then the same steps on
    the whole cache in this process alone; this rank's vocab shard of
    both runs' logits, the block against the whole cache's, the
    collectives, bytes and seconds."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.comm import Collectives, context_comm
    from repro_torch.distributed.sharding import (
        axis_sizes, cache_layout, cp_local_cache, tp_local_params)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.tree import tree_leaves

    dev = plan["dev"]
    D, m = plan["mesh"]
    mesh = make_test_mesh(data=D, model=m, device_type="cpu")
    mr = dist.get_rank(mesh.get_group("model"))
    out = []
    for case in plan["cases"]:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            get_config(case["arch"], smoke=plan["smoke"]), dtype="float32",
            n_layers=case["layers"])
        B, L, steps = case["batch"], case["cache_len"], case["steps"]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = TM.init_params(cfg, gen, device=dev)
        toks = torch.randint(0, cfg.vocab, (B, steps), generator=gen,
                             device=dev)
        whole = TM.init_cache(cfg, B, L, device=dev, mesh=None)
        for t in tree_leaves(whole):
            t.normal_(generator=gen).mul_(0.5)
        win = cfg.sliding_window
        T = min(L, win) if win > 0 else L
        lay = cache_layout(cfg, B, T, mesh)
        cp = context_comm(mesh, lay.time)
        tp = Collectives(mesh.get_group("model")) if m > 1 else None
        local = tp_local_params(params, cfg, mr, m) if m > 1 else params
        block = cp_local_cache(whole, cfg, mesh, rank)
        index = [torch.tensor(case["start"] + t, device=dev)
                 for t in range(steps)]

        def run(p, cache, **kw):
            logits = []
            with torch.no_grad():
                for t in range(steps):
                    lg, cache = TM.decode_step(p, cfg, cache, {
                        "tokens": toks[:, t:t + 1],
                        "cache_index": index[t]}, **kw)
                    logits.append(lg.float())
            return torch.stack(logits)

        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        setup_s = time.perf_counter() - t0
        sync()
        zero_counters()
        t0 = time.perf_counter()
        got = run(local, block, tp=tp, cp=cp)
        sync()
        cp_s = time.perf_counter() - t0
        launches = read_counters()
        want = run(params, whole)
        V = got.shape[-1]
        want = want[..., mr * V:(mr + 1) * V]
        # the block against the whole cache's: bit for bit where no step
        # wrote, within the tolerance where one did (every mamba state is
        # written at every step)
        written = torch.tensor([min(i, T - 1) if not win else i % T
                                for i in range(case["start"],
                                               case["start"] + steps)])
        same, err, scale = True, 0.0, 0.0
        for (a, b) in zip(tree_leaves(block), tree_leaves(
                cp_local_cache(whole, cfg, mesh, rank))):
            keep = torch.ones(a.shape, dtype=torch.bool, device=a.device)
            if a.ndim >= 4 and a.shape[-3] * cp.size == T and \
                    a.shape[-1] == cfg.head_dim:
                lo = cp.rank * a.shape[-3]
                mine = written[(written >= lo) & (written < lo + a.shape[-3])]
                keep[..., (mine - lo).tolist(), :, :] = False
            else:
                keep[...] = False
            same = same and bool(torch.equal(a[keep], b[keep]))
            if (~keep).any():
                err = max(err, float((a[~keep] - b[~keep]).abs().max()))
                scale = max(scale, float(b[~keep].abs().max()))
        nbytes = lambda tree: sum(t.numel() * t.element_size()
                                  for t in tree_leaves(tree))
        out.append({
            "logits": got.cpu().numpy(), "want": want.cpu().numpy(),
            "unwritten_bitwise": same, "written_max_abs_err": err,
            "written_max_abs_ref": scale,
            "cache_bytes": nbytes(block), "whole_cache_bytes": nbytes(whole),
            "c": cp.size, "time_axes": list(lay.time),
            "cp": dict(cp.counts), "tp": dict(tp.counts) if tp else None,
            "launches": launches, "setup_s": setup_s, "cp_decode_s": cp_s})
        del params, local, whole, block, got, want
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


#: phase 24's cases, by mesh (data, model): (arch, layers, batch, cache
#: length); the first index is 8 before the first block boundary (rank 0's
#: block ends: every rank holds T / (data · model) positions), or in a
#: ring cache 8 before its end, where the writes wrap to rank 0's block
CP_CASES = {(1, 2): (("granite-moe-1b-a400m", 4, 8, 32768),
                     ("hymba-1.5b", 4, 8, 32768)),
            (2, 2): (("granite-moe-1b-a400m", 4, 1, 32768),)}


def phase_cp_decode(torch, card: str, smoke: bool = False,
                    dev: str = "cuda") -> list:
    """Context-parallel decode caches (the reference's
    ``_cache_shardings`` layout): :data:`CP_CASES` on gloo processes on
    the one card (:func:`tp_spawn`, plans of kind ``"cp_decode"``), 16
    decode steps each, every rank against the same steps on the whole
    cache in its own process.  Gates: logits max |Δ| / max |ref| ≤ 2e-5
    on every rank's vocab shard, the tokens (argmax over the gathered
    vocab) equal; each rank's final block bit for bit the whole cache's
    where no step wrote, within 2e-5 of max |ref| where one did (past the
    first layer a written K/V comes from the layer's input, which the
    blocks' combined softmax sums round otherwise than one sum over the
    whole cache); cache bytes the whole cache's over the context group's
    size; the context and model groups' collectives exactly
    :func:`cp_expected` per step; ``moe_gmm`` once per MoE layer and
    step on each rank.  ``smoke`` and ``dev="cpu"``: the rehearsal at
    SMOKE widths on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (
        MeshShape, attn_split, cache_layout)

    steps = 16
    rows, bad = [], []
    for mesh_shape, group in CP_CASES.items():
        cases = []
        for arch, layers, B, L in group:
            L = 64 if smoke else L
            win = get_config(arch, smoke=smoke).sliding_window
            start = min(L, win) - 8 if win else \
                L // (mesh_shape[0] * mesh_shape[1]) - 8
            cases.append({"arch": arch, "layers": layers, "batch": B,
                          "cache_len": L, "start": start, "steps": steps})
        t0 = time.perf_counter()
        got = tp_spawn({"kind": "cp_decode", "world": mesh_shape[0] *
                        mesh_shape[1], "dev": dev, "smoke": smoke,
                        "mesh": mesh_shape, "cases": cases})
        seconds = time.perf_counter() - t0
        D, m = mesh_shape
        mesh = MeshShape(("data", "model"), mesh_shape)
        for i, case in enumerate(cases):
            cfg = dataclasses.replace(
                get_config(case["arch"], smoke=smoke),
                n_layers=case["layers"])
            win = cfg.sliding_window
            T = min(case["cache_len"], win) if win else case["cache_len"]
            lay = cache_layout(cfg, case["batch"], T, mesh)
            heads = m > 1 and attn_split(cfg, m) and "model" in lay.time
            cp_want, tp_want = cp_expected(cfg, m, heads)
            per = [got[r][i] for r in range(D * m)]
            cat = lambda k, d: np_concat([per[d * m + j][k]
                                          for j in range(m)])
            logits = [cat("logits", d) for d in range(D)]
            want = cat("want", 0)
            err = max(float(abs(x - want).max()) for x in logits)
            ref = float(abs(want).max())
            tokens_equal = all(bool((x[..., :cfg.vocab].argmax(-1) ==
                                     want[..., :cfg.vocab].argmax(-1)).all())
                               for x in logits)
            # the wrappers count launches of the kernels, on the card
            moe = case["layers"] * steps if cfg.n_experts and \
                dev == "cuda" else 0
            row = {"phase": "cp_decode", "card": card, "arch": cfg.name,
                   "layers": case["layers"], "mesh": f"data {D}, model {m}",
                   "backend": "gloo", "batch": case["batch"],
                   "cache_len": case["cache_len"], "T": T,
                   "time_axes": per[0]["time_axes"], "c": per[0]["c"],
                   "first_index": case["start"], "steps": steps,
                   "logits_max_abs_err": err, "logits_max_abs_ref": ref,
                   "tokens_equal": tokens_equal,
                   "unwritten_bitwise": [p["unwritten_bitwise"]
                                         for p in per],
                   "written_max_err_over_max": max(
                       p["written_max_abs_err"] /
                       max(p["written_max_abs_ref"], 1e-30) for p in per),
                   "cache_bytes_per_rank": [p["cache_bytes"] for p in per],
                   "whole_cache_bytes": per[0]["whole_cache_bytes"],
                   "cp_collectives": per[0]["cp"],
                   "tp_collectives": per[0]["tp"],
                   "expected_cp_collectives_per_step": cp_want,
                   "expected_tp_collectives_per_step": tp_want,
                   "moe_gmm_launches": [p["launches"]["moe_gmm"]
                                        for p in per],
                   "cp_decode_s": [p["cp_decode_s"] for p in per],
                   "setup_s": [p["setup_s"] for p in per],
                   "ranks_s": seconds}
            emit(row)
            rows.append(row)
            per_step = lambda d: d and {k: v * steps for k, v in d.items()}
            if err > 2e-5 * ref or not tokens_equal or \
                    not all(row["unwritten_bitwise"]) or \
                    row["written_max_err_over_max"] > 2e-5 or \
                    any(b * per[0]["c"] != per[0]["whole_cache_bytes"]
                        for b in row["cache_bytes_per_rank"]) or \
                    any(p["cp"] != per_step(cp_want) or
                        p["tp"] != per_step(tp_want) for p in per) or \
                    any(p["launches"] != dict(
                        dict.fromkeys(p["launches"], 0), moe_gmm=moe)
                        for p in per):
                bad.append(row)
    if bad:
        raise AssertionError(f"cp_decode: {bad}")
    return rows


def np_concat(arrays: list):
    import numpy as np
    return np.concatenate(arrays, axis=-1)


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
    from repro_torch.distributed.sharding import tp_local_config
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
    # a training microbatch of 4 x 1024 tokens (phase 13); C = 1024, the
    # EP round's 1024 tokens at capacity factor E / top_k (phase 18)
    moe_rows = timed(phase_moe_gmm, torch, cfg,
                     (("bfloat16", (8, 80, 256, 1280, 1024)),
                      ("float32", (8, 80, 256, 1024))))
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
    # each full-width train phase without remat first (the peak memory
    # and step time it costs), then with it (the default, whose launches
    # the kernels line reports)
    timed(phase_train, torch, cfg, smi, 4, 1024, 8, 2, False)
    train = timed(phase_train, torch, cfg, smi)
    timed(phase_train_cli, torch, cfg.name)
    # distribution at world size 1 on NCCL: the four policies' steps on a
    # mesh bitwise equal to the mesh-free ones, collectives counted; the
    # EP round through moe_gmm against the single-host moe_apply
    # (4 of granite's 24 layers: the check is bitwise and per leaf, and
    # the whole script must stay well inside its time limit)
    timed(phase_dist_policies, torch, dataclasses.replace(cfg, n_layers=4),
          smi)
    timed(phase_ep_round, torch, cfg, smi)
    # hymba-1.5b: 2-layer fp32 gradients in two chained scan chunks, then
    # full-width bf16 AdamW steps, seq 1024, 8 microbatches of 1 sequence
    # (without remat, then with it), then 4 microbatches of 2 sequences
    # (the AdamW steps at 8 of its 32 layers, to keep the whole script
    # well inside its time limit; train_fit's memory question at all 32)
    hymba8 = dataclasses.replace(hymba, n_layers=8)
    timed(phase_train_grads, torch, hymba, 256, 128)
    timed(phase_train, torch, hymba8, smi, 4, 1024, 8, 8, False)
    hymba_train = timed(phase_train, torch, hymba8, smi, 4, 1024, 8, 8)
    timed(phase_train_fit, torch, hymba, smi, 4)
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
    timed(phase_train, torch, whisper, smi, 4, 448, 8, 2, False)
    whisper_train = timed(phase_train, torch, whisper, smi, 4, 448, 8, 2)
    timed(phase_fp32_forward, torch, vlm, 64, "decode")
    timed(phase_wide_bf16, torch, vlm, smi, 512)
    # tensor parallelism (phase 19): the kernels at one model rank's shapes
    # of 2 (granite: H8 KV4, E16 at a training microbatch's C1280; hymba:
    # Di 1600), then two ranks training on the one card
    g2, h2 = tp_local_config(cfg, 2), tp_local_config(hymba, 2)
    rank2 = "model rank of 2"
    timed(phase_flash, torch, (A(g2, 1024, "bfloat16", B=4, what=rank2),))
    timed(phase_flash_bwd, torch, (A(g2, 1024, "bfloat16", B=4,
                                     what=rank2),))
    g2_moe = timed(phase_moe_gmm, torch, g2, (("bfloat16", (1280,)),))[0]
    g2_moe_bwd = timed(phase_moe_gmm_bwd, torch, g2,
                       (("bfloat16", (1280,)),))[0]
    timed(phase_ssm_scan, torch, (
        (f"hymba chunk, {rank2}, carried state", 1, 256, h2.d_inner,
         h2.ssm_state, True),))
    timed(phase_ssm_scan_bwd, torch, (
        (f"hymba chunk, {rank2}, carried state", 1, 256, h2.d_inner,
         h2.ssm_state, True),))
    tp_rows = timed(phase_tp_train, torch, cfg, hymba, smi)
    # the dry run of tp_train's configuration on the meta device
    timed(phase_dryrun, torch, cfg, smi, tp_rows)
    # expert parallelism under autograd (phase 20): the EP round forward
    # and backward on one NCCL rank against moe_apply, then two expert
    # ranks training full-width granite on the one card over gloo, then
    # four at (expert 2, data 2)
    ep_rows = timed(phase_ep_train, torch, cfg, smi)
    # tensor-parallel serving (phase 21): moe_gmm at one model rank of 2's
    # serving shapes (E 16 at a decode step's C 8 and a prefill round's C
    # 80), then one NCCL rank against the mesh-free batcher and two gloo
    # ranks serving on the one card
    g2_serve = timed(phase_moe_gmm, torch, g2, (("bfloat16", (8, 80)),))
    tp_serve = timed(phase_tp_serve, torch, cfg, hymba, smi, srv)
    # EP with a model axis (phase 22): (a) moe_gmm and its backward at one
    # rank of (expert 2, model 2)'s shapes (E 16 experts x 256 of their
    # d_ff columns: a decode step's C 8, a prefill round's C 80, a
    # training microbatch's round's C 1280), then four gloo ranks on the
    # one card training and serving full-width granite on that mesh
    g22 = dataclasses.replace(tp_local_config(dataclasses.replace(
        cfg, expert_parallel=True), 2, expert=2),
        n_experts=cfg.n_experts // 2)
    ep_tp_moe = timed(phase_moe_gmm, torch, g22,
                      (("bfloat16", (8, 80, 1280)),))
    ep_tp_moe_bwd = timed(phase_moe_gmm_bwd, torch, g22,
                          (("bfloat16", (1280,)),))[0]
    ep_tp = timed(phase_ep_tp, torch, cfg, smi, tp_serve["one_rank"])
    # a multi-pod mesh with a model axis (phase 23): eight gloo ranks at
    # (pod 2, data 2, model 2), granite at full width, 2 of its 24 layers
    timed(phase_multi_pod, torch, cfg, smi)
    # context-parallel decode caches (phase 24): granite and hymba-1.5b at
    # full width, 4 layers each, on 2 and 4 gloo ranks
    timed(phase_cp_decode, torch, smi)

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
         "launches": at_shape(srv["cli_moe_gmm_shapes"], moe_main),
         "shape": "E=32 C=8 d=1024 f=512 bf16 (decode step; the serve "
                  "CLI's launches at this shape)",
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
                  "training at 8 of its 32 layers, one launch per layer "
                  "and 256-token chunk)",
         "max_abs_err": ssm_bwd_main["max_abs_err"],
         "ms": ssm_bwd_main["kernel_ms"], "plain_ms": ssm_bwd_main["plain_ms"],
         "bound_ms": ssm_bwd_main["bound_ms"],
         "bound_by": ssm_bwd_main["bound_by"], "library_ms": None},
    ]
    # the EP path's kernels (phase 20): (a) one launch of each per round
    # at an expert axis of 1 (E 32), (b) one expert rank of 2 (E 16), its
    # launches per step
    ep_round_bf16 = next(r for r in ep_rows if r["check"] == "round"
                         and r["dtype"] == "bfloat16")
    moe_c1280 = next(r for r in moe_rows
                     if r["C"] == 1280 and r["dtype"] == "bfloat16")
    ep_cases = [(name, src_row, ep_round_bf16["launches_per_round"][name],
                 "E=32 C=1280 d=1024 f=512 bf16 (the EP round under "
                 "autograd at an expert axis of 1, a training microbatch "
                 "of 4096 tokens, launches per round)")
                for name, src_row in (("moe_gmm", moe_c1280),
                                      ("moe_gmm_bwd", moe_bwd_main))]
    ep_rank = next((r for r in ep_rows if r["check"] == "bf16"), None)
    if ep_rank is not None:
        ep_cases += [(name, src_row, ep_rank["launches"][0][name],
                      "E=16 C=1280 d=1024 f=512 bf16 (expert rank 0 of 2, "
                      "granite-moe-1b-a400m train step at 4 of its 24 "
                      "layers, launches per step)")
                     for name, src_row in (("moe_gmm", g2_moe),
                                           ("moe_gmm_bwd", g2_moe_bwd))]
    # model rank 0 of 2 serving: its launches at each shape, counted in
    # the run (one per layer and model launch, gated)
    srv2 = tp_serve["serve"]
    ep_cases += [("moe_gmm", row, at_shape(srv2["moe_gmm_shapes"], row),
                  f"E=16 C={row['C']} d=1024 f=512 bf16 (model rank 0 of 2 "
                  f"serving the closed batch over gloo; its launches at "
                  f"this shape in {srv2['decode_steps']} decode steps and "
                  f"{srv2['prefill_rounds']} prefill rounds)")
                 for row in g2_serve]
    # one rank of (expert 2, model 2): expert rank 0 / model rank 0's
    # launches per train step (lc, the config's capacity) and in the
    # closed batch at each serving shape
    at_c = {r["C"]: r for r in ep_tp_moe}
    tr, sv = ep_tp["train"][0], ep_tp["serve"]
    ep_tp_shape = ("E=16 C={} d=1024 f=256 bf16 (expert rank 0, model rank "
                   "0 of (expert 2, data 1, model 2): {})")
    ep_cases += [
        ("moe_gmm", at_c[1280], tr["launches"][0]["moe_gmm"],
         ep_tp_shape.format(1280, "granite-moe-1b-a400m train step, "
                                  "launches per step")),
        ("moe_gmm_bwd", ep_tp_moe_bwd, tr["launches"][0]["moe_gmm_bwd"],
         ep_tp_shape.format(1280, "granite-moe-1b-a400m train step, "
                                  "launches per step"))]
    ep_cases += [("moe_gmm", at_c[C], at_shape(sv["moe_gmm_shapes"],
                                               at_c[C]),
                  ep_tp_shape.format(C, f"serving the closed batch over "
                                        f"gloo; its launches at this shape "
                                        f"in {sv['decode_steps']} decode "
                                        f"steps and {sv['prefill_rounds']} "
                                        f"prefill rounds"))
                 for C in (8, 80)]
    for name, src_row, n, shape in ep_cases:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_dispatch/moe_gmm.py:62",
            "launches": n, "shape": shape,
            "max_abs_err": src_row["max_abs_err"], "ms": src_row["kernel_ms"],
            "plain_ms": src_row["plain_ms"], "bound_ms": src_row["bound_ms"],
            "bound_by": src_row["bound_by"],
            "library_ms": src_row["library_ms"]})
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
