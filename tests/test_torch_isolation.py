"""The port stands alone: no JAX, no reference package, no silent CPU
fallback.

* Every module of ``src/repro_torch`` and ``chip_smoke.py`` imports
  neither ``jax``/``jaxlib`` nor ``repro``/``repro.*`` (checked with
  ``ast``, so nothing needs to be imported to find out).
* The copied host modules (``sched/``, ``obs/``, ``core/``,
  ``data/pool.py``, ``data/pipeline.py`` and ``ep/plan.py``) are
  byte-identical to the reference's, except
  ``ExpertCapacityProvider.residual/overflow``.
* Entry points called without ``device=`` ask for the card and raise
  where there is none; kernel wrappers given CPU tensors run their plain
  version and do not count a launch.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("rel", FILES)
def test_module_imports_no_jax_and_no_reference(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


HOST_COPIES = sorted([str(p.relative_to(PORT))
                      for sub in ("sched", "obs", "core")
                      for p in (PORT / sub).glob("*.py")]
                     + ["data/pool.py", "data/pipeline.py", "ep/plan.py"])


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_modules_are_verbatim_copies(rel):
    port, ref = (PORT / rel).read_text(), (REF / rel).read_text()
    if rel == "sched/capacity.py":
        port = port.replace("import torch", "import jax.numpy as jnp") \
            .replace("torch.clamp(torch.as_tensor(self.slots_per_expert - "
                     "load),\n                           min=0)",
                     "jnp.maximum(self.slots_per_expert - load, 0)") \
            .replace("torch.clamp(torch.as_tensor(load - "
                     "self.slots_per_expert),\n                           "
                     "min=0)",
                     "jnp.maximum(load - self.slots_per_expert, 0)")
    assert port == ref


def _entry_points():
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve, train
    from repro_torch.models import model as TM
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.train.trainer import TrainerConfig, run_training

    cfg = get_config("qwen2.5-32b", smoke=True)
    return {
        "init_params": lambda: TM.init_params(cfg),
        "init_cache": lambda: TM.init_cache(cfg, 1, 8),
        "ContinuousBatcher": lambda: ContinuousBatcher(cfg, params={}),
        "bridge.to_torch": lambda: bridge.to_torch({"a": [1.0]}),
        "launch.serve.main": lambda: serve.main(
            ["--arch", "qwen2.5-32b", "--smoke"]),
        "run_training": lambda: run_training(
            cfg, ShapeConfig("s", 8, 2, "train"), TrainerConfig(steps=1)),
        "launch.train.main": lambda: train.main(
            ["--arch", "qwen2.5-32b", "--smoke", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["init_params", "init_cache",
                                  "ContinuousBatcher", "bridge.to_torch",
                                  "launch.serve.main", "run_training",
                                  "launch.train.main"])
def test_entry_point_without_device_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_kernel_wrappers_on_cpu_tensors_run_the_plain_version():
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    g = torch.Generator().manual_seed(0)
    buf, w1, w3 = (torch.randn(2, 8, 16, generator=g),
                   torch.randn(2, 16, 8, generator=g),
                   torch.randn(2, 16, 8, generator=g))
    w2 = torch.randn(2, 8, 16, generator=g)
    n0 = MG.launches
    assert torch.equal(MG.moe_gmm(buf, w1, w3, w2),
                       moe_gmm_ref(buf, w1, w3, w2))
    assert MG.launches == n0
    q = torch.randn(1, 8, 4, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    n0 = FA.launches
    assert torch.equal(FA.flash_attention(q, k, k), attention_ref(q, k, k))
    assert FA.launches == n0


def test_kernel_wrappers_refuse_mixed_devices():
    """A tensor off the CPU is never quietly moved back: the wrapper
    checks every input and raises (here: a meta tensor beside CPU ones)."""
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG

    buf = torch.zeros(2, 8, 16, device="meta")
    w = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        MG.moe_gmm(buf, w, w, torch.zeros(2, 8, 16))


def test_ssm_scan_wrapper_runs_plain_on_cpu_and_refuses_mixed_devices():
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    g = torch.Generator().manual_seed(0)
    dA, dBx = torch.rand(1, 6, 8, 4, generator=g), torch.randn(1, 6, 8, 4)
    C, h0 = torch.randn(1, 6, 4, generator=g), torch.randn(1, 8, 4)
    n0 = SS.launches
    for got, want in zip(SS.ssm_scan(dA, dBx, C, h0),
                         ssm_scan_ref(dA, dBx, C, h0)):
        assert torch.equal(got, want)
    assert SS.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssm_scan(dA, dBx, C, torch.zeros(1, 8, 4, device="meta"))
