"""The dry run on the meta device (``repro_torch.launch.dryrun``), its
roofline (``repro_torch.roofline``) and the pieces it traces through.

* **Counts** — a traced step's collectives per mesh axis equal the pins
  of the gloo tests that run the same (config, mesh, policy) on spawned
  ranks: ``tests/test_torch_sp.py``'s phi3 policies on ``(data 2, model
  2)``, ``(data 1, model 2)`` and ``(pod 2, data 2, model 2)`` and its
  granite fault M cases, and the full-width granite step of
  ``chip_smoke.py``'s ``tp_train`` (292 / 244 / 56 model-axis all-gathers
  / reduce-scatters / all-reduces, measured on the card).
* **Cells** — one cell per family on both production meshes traces with
  status ``ok``, rank 0's argument bytes exact, CUDA never initialised;
  a decode cell's cache bytes per rank are the reference's per-device
  bytes (``_cache_shardings``: the context-parallel layout); the CLI
  writes one record per cell, ``ok`` or ``skipped`` as
  ``shape_applicable`` says; ``reanalyze`` recomputes a record's roofline
  from its stored cost.
* **Pieces** — the kernel wrappers on meta tensors report their cost and
  count no launch; a ``Collectives`` over a ``MeshGroup`` issues nothing
  and counts kinds and bytes; the roofline's constants are the H100's.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.comm import (  # noqa: E402
    Collectives, MeshGroup, mesh_group,
)
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, tp_local_params,
)
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import reanalyze as RR  # noqa: E402
from repro_torch.roofline.op_counter import OpCounter  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytest.importorskip("jax")
import test_torch_sp as SP  # noqa: E402  (the gloo tests' pins)
from test_torch_cp import _paths, _reference_shardings  # noqa: E402

#: one arch per family
FAMILY_ARCHS = ("phi3-mini-3.8b", "granite-moe-1b-a400m", "falcon-mamba-7b",
                "hymba-1.5b", "whisper-medium", "llama-3.2-vision-90b")


def _sp_trace(fam, world, policy):
    """``tests/test_torch_sp.py``'s run of ``fam`` under ``policy`` on its
    ``world``-rank mesh, traced for rank 0."""
    arch, rep = SP.FAMILIES[fam]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **rep)
    shape = ShapeConfig("t", SP.SEQ, SP.BATCH, "train",
                        microbatches=SP.MICRO)
    return DR.trace_step(cfg, shape, SP.MESHES[world][0], policy=policy)


@pytest.mark.parametrize("world", sorted(SP.MESHES))
@pytest.mark.parametrize("policy", SP.POLICIES)
def test_dense_counts_equal_the_gloo_pins(world, policy):
    """phi3 SMOKE, each policy, on each of the SP test's meshes: the data
    axes' and the model axis's counts of the traced step are the ones the
    spawned ranks measure."""
    mesh, rows = SP.MESHES[world]
    got = _sp_trace("dense", world, policy)["collectives"]
    assert got["data"] == SP._data_collectives(policy, mesh, rows)
    assert got["model"] == SP._tp_collectives(
        get_config("phi3-mini-3.8b", smoke=True).n_layers)
    assert got["expert"] == {}


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("fam", SP.FAULT_M)
def test_moe_counts_equal_the_gloo_pins(world, fam):
    """granite SMOKE's fault M cases: the data axes' ``afe`` collectives
    plus one (``lc``) or two (``dlbc``) all-gathers of pair counts per MoE
    layer and forward, remat's recompute included, as the spawned ranks
    count them, and ``moe_gmm`` traced once per layer and forward,
    ``moe_gmm_bwd`` once per layer and backward."""
    mesh, rows = SP.MESHES[world]
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              **SP.FAMILIES[fam][1])
    rounds = 1 if cfg.moe_dispatch == "lc" else 2
    want = SP._data_collectives("afe", mesh, rows, fam)
    want["all_gather"] += SP.MICRO * 2 * cfg.n_layers * rounds
    model = SP._tp_collectives(cfg.n_layers)
    model["all_reduce"] += SP.MICRO * cfg.n_layers
    got = _sp_trace(fam, world, "afe")
    assert got["collectives"]["data"] == want
    assert got["collectives"]["model"] == model
    # forward, recompute and backward per layer and microbatch
    assert got["kernels"]["moe_gmm"]["calls"] == 2 * SP.MICRO * cfg.n_layers
    assert got["kernels"]["moe_gmm_bwd"]["calls"] == SP.MICRO * cfg.n_layers


def test_tp_train_counts_equal_the_card_run():
    """granite at full width, seq 1024, batch 8 in 2 microbatches, ``lc``,
    on ``(data 1, model 2)`` (``chip_smoke.py``'s ``tp_train``): the model
    axis's 292 all-gathers, 244 reduce-scatters and 56 all-reduces per
    step that the two ranks count on the card; the argument bytes are the
    rank's params and optimizer state (one rank of 2, so the params about
    half the whole model's)."""
    cfg = get_config("granite-moe-1b-a400m")
    got = DR.trace_step(cfg, ShapeConfig("t", 1024, 8, "train",
                                         microbatches=2),
                        MeshShape(("data", "model"), (1, 2)), policy="lc")
    model = got["collectives"]["model"]
    assert (model["all_gather"], model["reduce_scatter"],
            model["all_reduce"]) == (292, 244, 56)
    local = tree_leaves(tp_local_params(TM.param_shapes(cfg), cfg, 0, 2))
    n = sum(t.numel() for t in local)
    mem = got["memory"]
    # bf16, the routers fp32
    assert mem["params_bytes"] == sum(t.numel() * t.element_size()
                                      for t in local)
    assert mem["opt_state_bytes"] == 3 * 4 * n + 4  # m, v, master; step
    assert mem["batch_bytes"] == 2 * 8 * 1024 * 8            # tokens, labels
    assert mem["activation_bytes"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_cell_traces_on_meta(arch, multi_pod):
    """decode_32k of one arch per family on each production mesh: status
    ``ok``, rank 0's exact argument bytes (its params, rows and cache),
    the roofline on the H100's constants, no CUDA."""
    rec = DR.run_cell(arch, "decode_32k", multi_pod=multi_pod,
                      verbose=False)
    assert rec["status"] == "ok", rec
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    cfg = get_config(arch)
    local = tp_local_params(TM.param_shapes(cfg), cfg, 0, 16)
    mem = rec["memory"]
    assert mem["params_bytes"] == sum(t.numel() * t.element_size()
                                      for t in tree_leaves(local))
    mesh = production_mesh_shape(multi_pod=multi_pod)
    cache = TM.init_cache(cfg, 128, 32768, device="meta", mesh=mesh,
                          context=True)
    assert mem["cache_bytes"] == sum(t.numel() * t.element_size()
                                     for t in tree_leaves(cache))
    assert rec["roofline"]["chips"] == rec["chips"]
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert not torch.cuda.is_initialized()


def _reference_cache_bytes(arch, shape, multi_pod):
    """The reference's decode cache bytes per device: each leaf's shard
    shape under ``_cache_shardings`` on an ``AbstractMesh`` (no devices),
    ``cross_kv`` apart."""
    import jax.numpy as jnp
    from repro.configs import get_config as r_get_config
    from repro.models import model as JM

    cache_shardings, AbstractMesh = _reference_shardings()
    mesh = production_mesh_shape(multi_pod=multi_pod)
    amesh = AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    sh = SHAPES[shape]
    cfg = r_get_config(arch)
    shapes = JM.cache_shapes(cfg, sh.global_batch, sh.seq_len)
    specs = cache_shardings(shapes, amesh, cfg)
    out = {"self": 0, "cross_kv": 0}
    for (p, leaf), (_, spec) in zip(_paths(shapes), _paths(specs)):
        n = 1
        for d in spec.shard_shape(leaf.shape):
            n *= d
        out["cross_kv" if "cross_kv" in p else "self"] += \
            n * jnp.dtype(leaf.dtype).itemsize
    return out


@pytest.mark.parametrize("arch,shape,multi_pod,kv_bytes", [
    ("minitron-4b", "decode_32k", False, 2_147_483_648),
    ("granite-moe-1b-a400m", "decode_32k", True, 402_653_184),
    ("mixtral-8x7b", "long_500k", False, 2_097_152),
])
def test_decode_cell_cache_bytes_equal_the_reference(arch, shape, multi_pod,
                                                     kv_bytes):
    """A decode cell's cache bytes per rank are the reference's per-device
    bytes: minitron-4b's ``decode_32k`` on ``16x16`` (24 / 8 heads do not
    split 16 ways: 2.148 GB, not the 32.2 of every KV head on every model
    rank), granite's on ``2x16x16`` (4 rows per rank of 32 data ranks,
    0.403 GB) and mixtral's ``long_500k`` (B 1, its
    4096-slot ring over all 256 ranks: 2.1 MB, not 0.537 GB).  The three
    traces take about 7 s on one CPU process.  No layout note: only
    ``cross_kv`` is laid out otherwise."""
    rec = DR.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
    assert rec["status"] == "ok", rec
    ref = _reference_cache_bytes(arch, shape, multi_pod)
    assert ref["cross_kv"] == 0
    assert rec["memory"]["cache_bytes"] == ref["self"] == kv_bytes
    assert rec["layout"] == ""
    assert not torch.cuda.is_initialized()


def test_cli_writes_one_record_per_cell(tmp_path):
    """``main`` over two archs and ``long_500k`` on both meshes: falcon's
    cells ``ok``, its cache bytes the reference's per device (B 1 over 16
    or 32 data ranks: the mamba leaves whole in B, ``Di`` over
    ``"model"``) and no layout note, granite's ``skipped`` with
    ``shape_applicable``'s reason; one JSON file per cell; CUDA never
    initialised."""
    assert DR.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                    "--both-meshes", "--out", str(tmp_path)]) == 0
    assert DR.main(["--arch", "granite-moe-1b-a400m", "--shape",
                    "long_500k", "--both-meshes", "--out",
                    str(tmp_path)]) == 0
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(recs) == 4
    for rec in recs.values():
        ok, reason = shape_applicable(get_config(rec["arch"]),
                                      SHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skipped")
        assert rec["reason"] == reason
        if ok:
            assert rec["layout"] == ""
            assert rec["memory"]["cache_bytes"] == _reference_cache_bytes(
                rec["arch"], rec["shape"], rec["mesh"] == "2x16x16")["self"]
    assert not torch.cuda.is_initialized()


def test_reanalyze_round_trip(tmp_path):
    """A record's roofline, overwritten, is recomputed from its stored
    ``OpCost`` to the same values; a skipped record is left alone."""
    rec = DR.run_cell("whisper-medium", "decode_32k", verbose=False)
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(rec))
    spoilt = dict(rec, roofline={}, roofline_fraction=-1.0)
    path.write_text(json.dumps(spoilt))
    assert RR.reanalyze(path)
    back = json.loads(path.read_text())
    assert back["roofline"] == json.loads(json.dumps(rec["roofline"]))
    assert back["roofline_fraction"] == rec["roofline_fraction"]
    skipped = tmp_path / "skipped.json"
    skipped.write_text(json.dumps({"status": "skipped"}))
    assert not RR.reanalyze(skipped)


def test_roofline_constants_are_the_h100s():
    """bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s one way;
    a term is its count over its rate."""
    assert (RA.PEAK_FLOPS, RA.HBM_BW, RA.NVLINK_BW) == (989e12, 3.35e12,
                                                        450e9)
    assert RA.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12, "float32": 67e12,
                                      "tf32": 495e12}
    cost = RA.OpCost(flops=989e12, bytes=6.7e12,
                     coll_bytes={"all_reduce": 45e9},
                     coll_count={"all_reduce": 3})
    t = RA.roofline_from_opcost(cost, chips=2, model_flops=989e12)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.1)
    assert t.dominant == "memory" and t.collective_ops == 3
    assert RA.roofline_fraction(t) == pytest.approx(0.25)
    assert RA.bound_ms(3.35e9, 1.0, "bfloat16") == (1.0, "bytes")


def test_kernels_on_meta_report_their_cost_and_launch_nothing():
    """Each wrapper, forward and backward, on meta tensors: outputs of the
    right shapes, no launch counted, its FLOPs (flash 4·dh / 10·dh per
    visible pair and head, moe 6 / 16·E·C·d·f, the scan 4 / 10 per state
    and step) and bytes reported once per call."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.ssm_scan import ssm_scan as SS

    def meta(*s):
        return torch.empty(s, device="meta", requires_grad=True)

    before = (FA.launches, FA.bwd_launches, MG.launches, MG.bwd_launches,
              SS.launches, SS.bwd_launches)
    q, k = meta(2, 32, 4, 64), meta(2, 32, 2, 64)
    buf, w1, w2 = meta(4, 8, 16), meta(4, 16, 32), meta(4, 32, 16)
    dA, C = meta(1, 8, 16, 4), meta(1, 8, 4)
    with OpCounter() as c:
        o = FA.flash_attention(q, k, k, causal=True, window=8)
        y = MG.moe_gmm(buf, w1, w1, w2)
        s, h = SS.ssm_scan(dA, dA, C)
        (o.sum() + y.sum() + s.sum() + h.sum()).backward()
    assert o.shape == q.shape and y.shape == buf.shape
    assert s.shape == (1, 8, 16) and h.shape == (1, 16, 4)
    pairs = FA.visible_pairs(32, 32, True, 8)
    assert pairs == sum(min(i + 1, 8) for i in range(32))
    want = {"flash_attention": 4 * 64 * 2 * 4 * pairs,
            "flash_attention_bwd": 10 * 64 * 2 * 4 * pairs,
            "moe_gmm": 6 * 4 * 8 * 16 * 32,
            "moe_gmm_bwd": 16 * 4 * 8 * 16 * 32,
            "ssm_scan": 4 * 8 * 16 * 4, "ssm_scan_bwd": 10 * 8 * 16 * 4}
    assert {n: (v["calls"], v["flops"]) for n, v in c.kernels.items()} == \
        {n: (1, float(f)) for n, f in want.items()}
    assert c.kernels["moe_gmm"]["bytes"] == 4 * (2 * 4 * 8 * 16
                                                 + 3 * 4 * 16 * 32)
    assert (FA.launches, FA.bwd_launches, MG.launches, MG.bwd_launches,
            SS.launches, SS.bwd_launches) == before


def test_mesh_group_collectives_issue_nothing():
    """Over a ``MeshShape`` (no process group: ``torch.distributed`` is not
    initialised here) the groups are mesh rank 0's ``MeshGroup``; each
    collective returns the right shape and counts its kind and result
    bytes, also into an active op counter."""
    import torch.distributed as dist

    mesh = production_mesh_shape(multi_pod=True)
    group = mesh_group(mesh, ("pod", "data"))
    assert group == MeshGroup(mesh, ("pod", "data")) and group.size == 32
    c = Collectives(group)
    assert (c.size, c.rank, c.traced) == (32, 0, True)
    t = torch.empty(64, 8, device="meta")
    with OpCounter() as oc:
        assert c.all_gather(t).shape == (2048, 8)
        assert c.reduce_scatter(t).shape == (2, 8)
        assert c.all_reduce(t) is t
        assert c.all_to_all(t).shape == t.shape
    assert c.counts == {"all_reduce": 1, "reduce_scatter": 1,
                        "all_gather": 1, "all_to_all": 1, "send_recv": 0}
    assert oc.cost.coll_count == {"all_gather": 1, "reduce_scatter": 1,
                                  "all_reduce": 1, "all_to_all": 1}
    assert oc.cost.coll_bytes == {"all_gather": 2048 * 8 * 4,
                                  "reduce_scatter": 2 * 8 * 4,
                                  "all_reduce": 64 * 8 * 4,
                                  "all_to_all": 64 * 8 * 4}
    assert not dist.is_initialized()
