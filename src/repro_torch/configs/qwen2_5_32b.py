"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, qkv_bias.  Pure full attention → long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab=152064, qkv_bias=True,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    qkv_bias=True,
    source="reduced",
)
