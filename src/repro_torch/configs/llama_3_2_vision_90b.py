"""llama-3.2-vision-90b — VLM with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256; every 5th layer cross-attends to
vision embeddings.  The vision patch frontend is a STUB per the
assignment: input_specs() supplies precomputed patch embeddings
(vis_seq=1601).  Pure full attention → long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, cross_every=5, vis_seq=1601,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    cross_every=5, vis_seq=16,
    source="reduced",
)
