"""internlm2-20b — dense GQA.

[arXiv:2403.17297; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.  Pure full attention → long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544,
    source="[arXiv:2403.17297; hf]",
)

SMOKE = ModelConfig(
    name="internlm2-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    source="reduced",
)
