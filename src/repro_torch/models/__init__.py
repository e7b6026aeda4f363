from . import blocks, layers, model, moe  # noqa: F401
from .model import (  # noqa: F401
    decode_step, forward, init_cache, init_params, loss_fn, prefill_step,
)
