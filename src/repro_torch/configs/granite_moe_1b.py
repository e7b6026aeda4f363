"""granite-moe-1b-a400m — 32-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H
(GQA kv=8) d_ff=512 per expert, vocab=49155, MoE 32e top-8.
Experts are EP-sharded over the model axis (32 % 16 == 0).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=32, top_k=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=128,
    n_experts=4, top_k=2,
    source="reduced",
)
