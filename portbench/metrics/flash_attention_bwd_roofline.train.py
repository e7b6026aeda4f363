"""``flash_attention``'s backward kernels (``attn_bwd_dq*``,
``attn_bwd_dkv*``) against their least time over the causal (windowed)
pairs, summed over the traced steps' calls (one per layer and
microbatch), in %."""

from portbench.lib import costs
from portbench.lib.readers import train_roofline


def cost(m, t, b):
    dh = m.get("d_head") or m["d_model"] // m["n_heads"]
    return costs.flash_attention_bwd(b, t["seq_len"], m["n_heads"],
                                     m["n_kv_heads"], dh,
                                     m.get("sliding_window", 0))


def read(run):
    if run.kind != "train":
        return None
    return train_roofline(run, ("attn_bwd_dq", "attn_bwd_dkv"), cost)
