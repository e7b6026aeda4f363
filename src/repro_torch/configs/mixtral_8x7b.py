"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096.  8 experts do not divide the
16-way model axis → experts are TP-sharded on d_ff (14336/16 = 896).
SWA ⇒ sub-quadratic ⇒ long_500k RUNS.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, n_experts=8, top_k=2, sliding_window=4096,
    source="[arXiv:2401.04088; hf]",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
    n_experts=4, top_k=2, sliding_window=32,
    source="reduced",
)
