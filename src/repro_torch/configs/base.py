"""Model + shape configuration system.

``ModelConfig`` describes an architecture (one file per assigned arch in
this package); ``ShapeConfig`` describes an input-shape cell (train_4k /
prefill_32k / decode_32k / long_500k).  A copy of the JAX package's
configs without its dry-run ``input_specs`` (the dry-run is not ported).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "dlbc"  # "lc" (static GShard) | "dlbc" (two-round)
    #: opt in to expert-parallel all-to-all dispatch (repro.ep): taken
    #: when the mesh carves an "expert" axis that divides E and T,
    #: otherwise falls back to the single-host dispatch path
    expert_parallel: bool = False
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    # --- attention ---
    sliding_window: int = 0  # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0  # audio frames after the (stubbed) conv frontend
    # --- VLM (llama-3.2-vision) ---
    cross_every: int = 0  # every k-th layer is cross-attention
    vis_seq: int = 0      # vision tokens from the (stubbed) patch frontend
    # --- numerics / structure ---
    norm: str = "rmsnorm"   # rmsnorm | layernorm
    act: str = "swiglu"     # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # citation tag [source; verification tier]
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embedding/lm_head shard 16-way
        (standard Megatron-style vocab padding; tail masked in the loss)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def head_dim(self) -> int:
        if self.n_heads == 0:
            return self.d_head  # attention-free (SSM) archs
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell?  SSM / hybrid / SWA yes;
        pure full attention no (skip noted in DESIGN.md)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Approximate parameter count (embedding + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h = self.head_dim
        per_attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) \
            + (self.n_heads * h) * d
        if self.act == "swiglu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        per_ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, n = self.d_inner or 2 * d, self.ssm_state
            dtr = self.dt_rank or max(1, d // 16)
            per_ssm = d * 2 * di + di * self.conv_width \
                + di * (dtr + 2 * n) + dtr * di + di * n + di * d
        total = 0
        for i in range(self.n_layers):
            if self.family == "dense" or self.family == "encdec":
                total += per_attn + per_mlp
            elif self.family == "moe":
                total += per_attn + self.n_experts * per_mlp
            elif self.family == "ssm":
                total += per_ssm
            elif self.family == "hybrid":
                total += per_attn + per_ssm + per_mlp
            elif self.family == "vlm":
                total += per_attn + per_mlp  # cross layers ≈ same size
        if self.family == "encdec":
            total += self.enc_layers * (per_attn + per_mlp)
            total += self.n_layers * per_attn  # decoder cross-attention
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        per_mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        dead = self.n_layers * (self.n_experts - self.top_k) * per_mlp
        return self.n_params() - dead


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    microbatches: int = 1  # gradient-accumulation steps (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(ok, reason) — long_500k only for sub-quadratic archs (per spec)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full-attention; long_500k needs "
            "sub-quadratic attention (skip recorded in DESIGN.md)"
        )
    return True, ""
