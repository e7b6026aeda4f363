"""The yardstick: the H100's published peaks, the model FLOPs of a step,
and the least operations and bytes each of the port's kernels needs.

Frozen here so that a change to the program cannot change what it is
measured against.  The peaks are NVIDIA's H100 SXM5 80GB data sheet,
dense (no sparsity), at the full 700 W: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of HBM3 (copied from
``repro_torch/roofline/analysis.py`` and ``chip_smoke.py``'s ``mfu``).

``model_flops`` is the reference's ``model_flops_estimate``: 6·N_active
per trained token, 2·N_active per prefilled or decoded token, with
``N_active`` the configuration's ``n_active_params`` (embedding and head
counted, top_k of n_experts for a mixture).

Each kernel's cost counts each input byte once and each output byte once
(scratch it writes and reads again is not counted) and the operations of
its products; where the work depends on the inputs (the causal triangle,
a window, routing) it counts the pairs these inputs need: the expert
kernels' rows are the routed pairs the call keeps (``lib.routed``), not
the buffer's capacity.
"""

from __future__ import annotations

from .cell import family

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card needs: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)


def decoder_params(model: dict, per_layer: int) -> int:
    """Active parameters of a decoder whose layers hold the attention and
    ``per_layer`` more, embedding and head counted."""
    d, V = model["d_model"], model["vocab"]
    H, KV = model["n_heads"], model["n_kv_heads"]
    h = model.get("d_head") or d // H
    per_attn = d * H * h + 2 * d * KV * h + H * h * d
    return model["n_layers"] * (per_attn + per_layer) + V * d * 2


def n_active_params(model: dict) -> int:
    """``ModelConfig.n_active_params`` of the reference: the family's
    (``portbench/families/<family>.py``)."""
    return family(model["family"]).n_active_params(model)


def model_flops(model: dict, tokens: int, train: bool) -> float:
    return (6.0 if train else 2.0) * n_active_params(model) * tokens


def causal_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs of a causal (windowed) attention over S positions."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


# --- the port's kernels: (flops, bytes) of one call ------------------------

def moe_gmm(E, rows, d, f, esize=2):
    """``out = (silu(buf·w1) ⊙ buf·w3)·w2`` over the ``rows`` filled rows
    of the (E, C, d) buffers (the routed pairs the call keeps; the empty
    slots need no work): reads those rows and every expert's weights,
    writes those rows."""
    return 6.0 * rows * d * f, esize * (2 * rows * d + 3 * E * d * f)


def moe_gmm_bwd(E, rows, d, f, esize=2):
    """Its gradient over the same rows: a and b recomputed, dh, dw2, dw1,
    dw3, dbuf (eight products of 2·rows·d·f); reads buf, dout, w1, w3, w2,
    writes dbuf, dw1, dw3, dw2."""
    return 16.0 * rows * d * f, esize * (3 * rows * d + 6 * E * d * f)


def flash_attention_bwd(B, S, H, KV, dh, window=0, esize=2):
    """Its gradient: QKᵀ recomputed, dP, dV, dQ, dK (five products over
    the causal pairs); reads q, k, v, o, dout, writes dq, dk, dv."""
    pairs = causal_pairs(S, window)
    return 10.0 * B * H * dh * pairs, \
        esize * B * S * dh * (3 * H + 2 * KV) + esize * B * S * dh * \
        (H + 2 * KV)

