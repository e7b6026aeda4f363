"""falcon-mamba-7b — attention-free Mamba-1 SSM.

[arXiv:2410.05355; unverified]  64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16, d_inner=8192, dt_rank=256.  Sub-quadratic → long_500k RUNS.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=65024, ssm_state=16, d_inner=8192, dt_rank=256, conv_width=4,
    source="[arXiv:2410.05355; unverified]",
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
    ssm_state=4, d_inner=128, dt_rank=8, conv_width=4,
    source="reduced",
)
