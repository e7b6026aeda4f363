"""whisper-medium — enc-dec audio transformer backbone.

[arXiv:2212.04356; unverified]  24L decoder (+24L encoder) d_model=1024
16H (GQA kv=16 ⇒ MHA) d_ff=4096 vocab=51865.  The conv audio frontend is a
STUB per the assignment: input_specs() provides precomputed frame
embeddings (1500 frames).  Pure full attention → long_500k skipped
(DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    enc_layers=24, enc_seq=1500,
    norm="layernorm", act="gelu", rope_theta=0.0,  # learned/abs pos (stubbed as rope-free)
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    enc_layers=2, enc_seq=32, norm="layernorm", act="gelu", rope_theta=0.0,
    source="reduced",
)
