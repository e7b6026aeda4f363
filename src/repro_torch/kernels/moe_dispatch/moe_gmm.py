"""Grouped expert SwiGLU FFN and its gradient: wrapper of the CUDA kernels
``csrc/moe_gmm.cu``.

Port of the Pallas kernel ``repro/kernels/moe_dispatch/moe_gmm.py``:
``out[e] = (silu(buf[e]·w1[e]) ⊙ (buf[e]·w3[e]))·w2[e]`` over capacity
buffers ``(E, C, d)``, any C, d and f multiples of 8.  On the card one
call runs two grouped GEMMs, gate-up into a scratch ``h (E, C, f)`` and
down into the output, with the tiles, ring depth and K splits of
:func:`launch_plan`.  CPU tensors run the plain version
(:func:`~.ref.moe_gmm_ref`); CUDA tensors launch the kernels or raise;
meta tensors (the dry run) return empty outputs and report the kernels'
cost to the active op counter (:mod:`repro_torch.roofline.sink`).
``launches`` counts wrapper calls that launched (one per call on the
card, however many kernels it issues).

On CUDA tensors in grad mode the call goes through :class:`MoeGmmFn`,
whose backward launches ``moe_gmm_bwd_launch``: four grouped GEMMs under
:func:`backward_plan` (``a = buf·w1``, ``b = buf·w3`` and ``dh =
dout·w2ᵀ`` in one kernel's fp32 accumulators, with the SwiGLU backward in
its epilogue; ``dw2 = hᵀ·dout``; ``dw1, dw3 = bufᵀ·(da, db)``; ``dbuf =
da·w1ᵀ + db·w3ᵀ``); bf16 runs them on ``wgmma`` with TMA, 128-row tiles,
fp32 on the forward's ``mma.sync`` loop with 64-row tiles.  a and b are recomputed rather than saved: the
forward keeps only its inputs, and the backward's scratch is da, db and h,
3 × (E, C, f) in buf's dtype (granite at C 1280 in bf16: 126 MB per layer,
freed when the call returns).  ``bwd_launches`` counts backward calls.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _build
from ...roofline import sink
from .ref import moe_gmm_ref

#: calls that launched the kernels since the last reset (plain ints;
#: callers zero them)
launches = 0
bwd_launches = 0

#: weight columns of one tile: 64 of w1 beside the same 64 of w3 (gate-up),
#: or 128 of w2 (down)
WEIGHT_COLS = 128
#: the C-row tiles built, each with its ring depth (``MOE_GMM_TILES`` in
#: the source): deeper rings for the small tiles, which are bound by bytes
STAGES = {32: 8, 64: 6, 128: 4}
#: K per ring slot: 64 bytes of bf16 or fp32
BLOCK_K = {torch.bfloat16: 32, torch.float32: 16}
#: blocks resident per SM (the kernels' launch bounds)
BLOCKS_PER_SM = 2


class GemmPlan(NamedTuple):
    """One of the two launches: output tile ``block_m × block_n``, K step
    ``block_k``, ring depth, K splits and grid ``(C tiles × N tiles, E,
    splits)``."""

    block_m: int
    block_n: int
    block_k: int
    stages: int
    splits: int
    grid: tuple


class LaunchPlan(NamedTuple):
    gate_up: GemmPlan
    down: GemmPlan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_m(C: int, dtype: torch.dtype) -> int:
    """The C tile: the smallest built tile that holds C, or for C > 64 the
    one of 64 and 128 that pads C least (128 on a tie, which reads each
    weight tile fewer times).  fp32 stops at 64, since its per-slot
    partial sums double the accumulator registers."""
    if C <= 64 or dtype == torch.float32:
        return 32 if C <= 32 else 64
    return 128 if _cdiv(C, 128) * 128 <= _cdiv(C, 64) * 64 else 64


@functools.lru_cache(maxsize=None)
def launch_plan(E: int, C: int, d: int, f: int, dtype: torch.dtype,
                n_sms: int) -> LaunchPlan:
    """The plan of both kernels for one shape.  gate-up: ``block_m`` rows ×
    64 columns of h over K = d; down: ``block_m`` × 128 columns of out over
    K = f, its K tiles split in two until the grid fills the card's block
    slots (each split keeps at least two rings of K tiles, and the splits
    divide the K tiles)."""
    bm, bk = block_m(C, dtype), BLOCK_K[dtype]
    m_tiles = _cdiv(C, bm)
    bn_gu, bn_dn = WEIGHT_COLS // 2, WEIGHT_COLS
    stages = STAGES[bm]
    gate_up = GemmPlan(bm, bn_gu, bk, stages, 1,
                       (m_tiles * _cdiv(f, bn_gu), E, 1))
    blocks = m_tiles * _cdiv(d, bn_dn) * E
    k_tiles = _cdiv(f, bk)
    splits = 1
    while (2 * splits * blocks <= BLOCKS_PER_SM * n_sms
           and k_tiles % (2 * splits) == 0
           and k_tiles // (2 * splits) >= 2 * stages):
        splits *= 2
    down = GemmPlan(bm, bn_dn, bk, stages, splits,
                    (m_tiles * _cdiv(d, bn_dn), E, splits))
    return LaunchPlan(gate_up, down)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_shapes(buf, w1, w3, w2) -> tuple:
    E, C, d = buf.shape
    f = w1.shape[-1]
    if w1.shape != (E, d, f) or w3.shape != (E, d, f) or w2.shape != (E, f, d):
        raise ValueError(f"moe_gmm: shapes buf {tuple(buf.shape)} w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)} do not agree")
    if d % 8 or f % 8:
        raise ValueError(f"moe_gmm: d={d} and f={f} must be multiples of 8 "
                         f"(the kernels move 16-byte vectors of rows)")
    if any(t.data_ptr() % 16 for t in (buf, w1, w3, w2)):
        raise ValueError("moe_gmm: inputs must be 16-byte aligned")
    return E, C, d, f


#: the backward's output rows per tile: bf16 runs on ``wgmma`` with 128-row
#: tiles (two consumer warpgroups of 64 rows, ``kWgBM`` in the source);
#: fp32 (3xTF32) keeps ``mma.sync`` and 64-row tiles (``kBwdBM``)
BWD_BLOCK_M = {torch.bfloat16: 128, torch.float32: 64}
#: ring stages of the four backward GEMMs in launch order (``WgOp::kStages``
#: for bf16, ``kBwdStages`` for fp32)
BWD_STAGES = {torch.bfloat16: (4, 4, 4, 4), torch.float32: (4, 4, 4, 4)}
#: K per ring stage: one 128-byte swizzle row of bf16 (``kWgBK``); 64 bytes
#: of fp32 (the forward's ``BLOCK_K``)
BWD_BLOCK_K = {torch.bfloat16: 64, torch.float32: 16}


class BackwardGemm(NamedTuple):
    """One kernel of the backward: ``M × N`` outputs over ``K``, ``nb``
    weight operands side by side, ``tiles`` output tiles of ``block_m ×
    block_n`` (M tiles × N tiles × E) over a ring of ``stages`` K steps of
    ``block_k`` in ``smem`` bytes of dynamic shared memory.  ``grid``: bf16
    runs a persistent grid of ``(min(tiles, SMs), 1)`` blocks, each
    walking its tiles; fp32 one block per tile, ``(M tiles × N tiles,
    E)``."""

    name: str
    M: int
    K: int
    N: int
    nb: int
    block_m: int
    block_n: int
    block_k: int
    stages: int
    smem: int
    tiles: int
    grid: tuple


def _bwd_smem(kind: str, nb: int, bm: int, bn: int, bk: int, stages: int,
              dtype: torch.dtype) -> int:
    """Dynamic shared memory of one backward kernel, as the source sizes
    it.  bf16 (``WgOp::kSmem``): 1 KB of alignment slack, the ring (A
    tiles ``bm × bk``, two of them for kDh; the B tile of accumulator 0,
    128 (kDh) or 256 columns by ``bk``, and kDh's 64 × ``bk`` of w2), two
    mbarriers per stage.  fp32 (``smem_bytes`` of the ``mma.sync`` loop's
    ``Slot``): padded A and B tiles per stage."""
    if dtype == torch.bfloat16:
        dh = kind == "dh"
        stage = ((2 if dh else 1) * bm * bk + (128 if dh else 256) * bk
                 + (64 * bk if dh else 0)) * 2
        return 1024 + stages * stage + 2 * stages * 8
    epc, cols = 4, WEIGHT_COLS
    sa = bm + 8 if kind == "dw" else bk + epc
    a1 = bk * sa if kind == "dw" else bm * sa
    sb = bk + epc if kind == "dx" else cols + 8
    b1 = cols * sb if kind == "dx" else bk * sb
    a, b = (2 * a1, b1 + (cols // 2) * (bk + epc)) if kind == "dh" \
        else (a1, b1)
    return stages * (a + b) * 4


@functools.lru_cache(maxsize=None)
def backward_plan(E: int, C: int, d: int, f: int,
                  dtype: torch.dtype = torch.bfloat16,
                  n_sms: int = 132) -> tuple:
    """The four grouped GEMMs of one backward call, in launch order, with
    their tiles for ``dtype`` on a card of ``n_sms`` SMs (the launch plan
    of the forward, :func:`launch_plan`, is separate).  bf16 tiles are 256
    output columns wide where one product fills the 64 × 256 accumulator
    (dw2, dbuf), 128 of each of dw1 and dw3 side by side, and 64 for kDh
    (64 columns each of a and b in one 64 × 128 accumulator, and of dh in
    a 64 × 64 one); fp32 tiles are 128 / nb wide."""
    bm, bk = BWD_BLOCK_M[dtype], BWD_BLOCK_K[dtype]

    def gemm(i, kind, name, M, K, N, nb):
        if dtype == torch.bfloat16:
            bn = 64 if kind == "dh" else 128 if nb == 2 else 256
        else:
            bn = WEIGHT_COLS // nb
        stages = BWD_STAGES[dtype][i]
        mn = _cdiv(M, bm) * _cdiv(N, bn)
        grid = (min(mn * E, n_sms), 1) if dtype == torch.bfloat16 \
            else (mn, E)
        return BackwardGemm(name, M, K, N, nb, bm, bn, bk, stages,
                            _bwd_smem(kind, nb, bm, bn, bk, stages, dtype),
                            mn * E, grid)
    return (gemm(0, "dh", "a, b, dh = buf·w1, buf·w3, dout·w2ᵀ → da, db, h",
                 C, d, f, 2),
            gemm(1, "dw", "dw2 = hᵀ·dout", f, C, d, 1),
            gemm(2, "dw", "dw1, dw3 = bufᵀ·da, bufᵀ·db", d, C, f, 2),
            gemm(3, "dx", "dbuf = da·w1ᵀ + db·w3ᵀ", C, 2 * f, d, 1))


def _forward(buf, w1, w3, w2) -> torch.Tensor:
    global launches
    if _build.all_on_meta(buf, w1, w3, w2):
        # three (C, d) × (d, f)-sized products per expert, 2 FLOPs each
        E, C, d = buf.shape
        out = torch.empty_like(buf)
        sink.kernel("moe_gmm", 6.0 * E * C * d * w1.shape[-1],
                    _build.nbytes(buf, w1, w3, w2, out))
        return out
    code = _build.cuda_inputs("moe_gmm", buf, w1, w3, w2)
    E, C, d, f = _check_shapes(buf, w1, w3, w2)
    out = torch.empty_like(buf)
    if buf.numel() == 0:
        return out
    plan = launch_plan(E, C, d, f, buf.dtype, _sm_count(buf.device.index))
    run_plan(buf, w1, w3, w2, out, plan, code)
    launches += 1
    return out


def moe_gmm_bwd(buf, w1, w3, w2, dout) -> tuple:
    """Launch the backward kernels: ``(dbuf, dw1, dw3, dw2)`` in buf's
    dtype for ``dout`` = dL/dout."""
    global bwd_launches
    if _build.all_on_meta(buf, w1, w3, w2, dout):
        # eight products of the forward's size: a, b and dh, dw2, dw1 and
        # dw3, dbuf's two
        E, C, d = buf.shape
        grads = tuple(torch.empty_like(t) for t in (buf, w1, w3, w2))
        sink.kernel("moe_gmm_bwd", 16.0 * E * C * d * w1.shape[-1],
                    _build.nbytes(buf, w1, w3, w2, dout, *grads))
        return grads
    code = _build.cuda_inputs("moe_gmm", buf, w1, w3, w2, dout)
    E, C, d, f = _check_shapes(buf, w1, w3, w2)
    if dout.shape != buf.shape or dout.data_ptr() % 16:
        raise ValueError(f"moe_gmm_bwd: dout {tuple(dout.shape)} must match "
                         f"buf {tuple(buf.shape)} and be 16-byte aligned")
    grads = tuple(torch.empty_like(t) for t in (buf, w1, w3, w2))
    if buf.numel() == 0:
        return tuple(g.zero_() for g in grads)
    da, db, h = (torch.empty((E, C, f), dtype=buf.dtype, device=buf.device)
                 for _ in range(3))
    dbuf, dw1, dw3, dw2 = grads
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = _build.entry("moe_gmm_bwd")(
        buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        dout.data_ptr(), da.data_ptr(), db.data_ptr(), h.data_ptr(),
        dbuf.data_ptr(), dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(),
        E, C, d, f, code, stream)
    _build.check("moe_gmm_bwd", rc)
    bwd_launches += 1
    return grads


class MoeGmmFn(torch.autograd.Function):
    """The kernel pair under autograd: the forward saves its inputs; the
    backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, buf, w1, w3, w2):
        ctx.save_for_backward(buf, w1, w3, w2)
        return _forward(buf, w1, w3, w2)

    @staticmethod
    def backward(ctx, dout):
        return moe_gmm_bwd(*ctx.saved_tensors, dout.contiguous())


def moe_gmm(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d); w1/w3 (E, d, f); w2 (E, f, d) → (E, C, d) in buf's
    dtype, fp32 inside.  Differentiable on both devices."""
    if _build.all_on_cpu(buf, w1, w3, w2):
        return moe_gmm_ref(buf, w1, w3, w2)
    if _build.needs_grad(buf, w1, w3, w2):
        return MoeGmmFn.apply(buf, w1, w3, w2)
    return _forward(buf, w1, w3, w2)


def run_plan(buf, w1, w3, w2, out, plan: LaunchPlan, code: int) -> None:
    """Launch both kernels under ``plan`` (inputs already checked)."""
    E, C, d = buf.shape
    f = w1.shape[-1]
    h = torch.empty((E, C, f), dtype=buf.dtype, device=buf.device)
    splits = plan.down.splits
    scratch = (torch.empty(splits * E * C * d, dtype=torch.float32,
                           device=buf.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = _build.entry("moe_gmm")(
        buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        h.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        E, C, d, f, plan.down.block_m, plan.down.stages, splits, code, stream)
    _build.check("moe_gmm", rc)
