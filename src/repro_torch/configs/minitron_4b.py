"""minitron-4b — pruned Nemotron, dense GQA, 256k vocab.

[arXiv:2407.14679; hf]  32L d_model=3072 24H (GQA kv=8, head_dim 128)
d_ff=9216 vocab=256000.  The 256k vocab stresses embedding/output
sharding.  Pure full attention → long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000, d_head=128,
    source="[arXiv:2407.14679; hf]",
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    d_head=16,
    source="reduced",
)
