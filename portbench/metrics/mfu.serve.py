"""Model FLOPs of the unprofiled window (2·N_active per prompt token
prefilled, from the batcher's ``prefill_tokens`` counter, and per token
generated; padded lanes not counted) over the window and the bf16 peak
of 989 TFLOP/s, in %."""

from portbench.lib import costs


def read(run):
    if run.kind != "serve":
        return None
    w = run.window
    tokens = w["prefill_tokens"] + w["generated"]
    return 100.0 * costs.model_flops(run.model, tokens, False) \
        / w["seconds"] / costs.PEAK_FLOPS["bfloat16"]
