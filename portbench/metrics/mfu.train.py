"""Model FLOPs of the unprofiled window's steps (6·N_active per trained
token) over the window and the bf16 peak of 989 TFLOP/s, in %."""

from portbench.lib import costs


def read(run):
    if run.kind != "train":
        return None
    w = run.window
    return 100.0 * costs.model_flops(run.model, w["tokens"], True) \
        / w["seconds"] / costs.PEAK_FLOPS["bfloat16"]
