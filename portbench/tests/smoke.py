"""Smoke-sized copies of the benchmark's cells for the CPU tests: the
cells' own traffic kinds, metrics and limits, at SMOKE widths in fp32, so
that the kernels' plain versions run."""

from __future__ import annotations

from portbench.lib.cell import Cell, load

SMOKE = {
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
                vocab=128, n_experts=4, top_k=2),
}


def smoke_cell(name: str, **model) -> Cell:
    """The cell at SMOKE sizes.  A serving cell serves every routed pair
    there (capacity factor E / top_k): at 4 slots of 16-token chunks and 4
    experts the static prefill buffer's padded lanes overflow the experts
    at the configuration's 1.25 and drop real pairs on most seeds (the
    program fault of PERF.md's Open questions), which would fail every
    run and hide the faults the tests plant.  At the cell's own size the
    chip runs read mean gaps far under the limit at 1.25."""
    c = load(name)
    m = dict(c.config["model"], dtype="float32")
    m.update(SMOKE[m["family"]])
    t = dict(c.traffic)
    if t["kind"] == "train":
        t.update(seq_len=64, global_batch=4, microbatches=2, trace_steps=1)
    else:
        m["moe_capacity_factor"] = m["n_experts"] / m["top_k"]
        t.update(clients=6, n_slots=4, cache_len=128, prefill_chunk=16,
                 pool=20, warmup_steps=3, trace_steps=2,
                 prompt=dict(t["prompt"], median=30, min=8, max=60),
                 output=dict(t["output"], median=6, min=2, max=12),
                 check={"served_tokens": 20})
    m.update(model)
    return Cell(name=c.name, config=dict(c.config, model=m), traffic=t,
                end_to_end=c.end_to_end, per_layer=c.per_layer, chips=1,
                limits=c.limits)
