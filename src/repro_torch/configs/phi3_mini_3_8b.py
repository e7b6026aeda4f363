"""phi3-mini-3.8b — dense RoPE/SwiGLU, MHA-equivalent GQA (kv=32).

[arXiv:2404.14219; unverified]  32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064.  Pure full attention → long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064,
    source="[arXiv:2404.14219; unverified]",
)

SMOKE = ModelConfig(
    name="phi3-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    source="reduced",
)
