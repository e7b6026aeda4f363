"""hymba-1.5b — hybrid parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5, head_dim 64)
d_ff=5504 vocab=32001, ssm_state=16; attention is sliding-window (global
layers approximated as SWA per backbone spec).  Sub-quadratic ⇒ long_500k
RUNS.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, ssm_state=16, d_inner=3200, dt_rank=100, conv_width=4,
    sliding_window=1024, d_head=64,
    source="[arXiv:2411.13676; hf]",
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    ssm_state=4, d_inner=128, dt_rank=8, conv_width=4, sliding_window=32,
    d_head=16,
    source="reduced",
)
