"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py``; runs on the card unless ``device="cpu"``
is passed.  Eager PyTorch stands in for the reference's ``jax.jit`` of the
step, and one ``torch.cuda.synchronize()`` per step stands where the
reference blocks on the gradient norm.

Large-scale runnability features (designed for 1000+ nodes, exercised on
one device):

* **checkpoint/restart** — async sharded checkpoints every
  ``ckpt_every`` steps; on (re)start the trainer scans for the newest
  *complete* checkpoint and resumes exactly (data pipeline is a pure
  function of step → bitwise-identical batch replay);
* **failure injection** — ``failure_at`` simulates a node crash
  mid-training (raises after the step completes); integration tests
  restart the trainer and verify loss-curve continuity;
* **straggler mitigation** — per-step wall-time EWMA; steps slower than
  ``straggler_factor ×`` the median are logged and counted (on real
  hardware this feeds the reshard/hot-spare controller; here it drives
  the metric surface the tests assert on);
* **restart on another device** — restore() places the tensors on the
  device of this run (the mesh resharding of the reference waits for
  ROADMAP Queue 1 item 11);
* **non-finite-grad guard** — the optimizer skips bad steps atomically
  (the paper's exception semantics: a failure inside the step must not
  poison the join).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..device import resolve_device
from ..models import model as MDL
from ..obs import metrics as obs_metrics
from ..obs import trace as obs
from ..sched import SchedTelemetry
from ..tree import tree_map
from .optimizer import AdamWConfig, init_opt_state
from .train_step import StepConfig, build_eval_loss, build_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    failure_at: Optional[int] = None  # simulate a crash after this step
    seed: int = 0
    ckpt_sched_policy: str = "dcafe"  # shard-write scheduling (repro.sched)
    #: run checkpoint shard writes on the adaptive work-stealing executor
    #: (steal-driven chunk splitting; grain from the policy's controller)
    ckpt_stealing: bool = False


@dataclass
class TrainReport:
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    stragglers: int = 0
    resumed_from: Optional[int] = None
    completed: int = 0
    #: Fig. 10-comparable per-surface spawn/join/latency telemetry
    sched: dict = field(default_factory=dict)


class SimulatedFailure(RuntimeError):
    pass


# Metrics-plane handles (looked up once; bumped once per training step —
# the same per-scheduling-edge discipline as the sched.* handles).
_MX_STEPS = obs_metrics.counter("train.steps")
_MX_STRAGGLERS = obs_metrics.counter("train.stragglers")
_MX_STEP_S = obs_metrics.histogram("train.step_s")
_MX_LOSS = obs_metrics.gauge("train.loss")
_MX_GRAD_NORM = obs_metrics.gauge("train.grad_norm")


def run_training(cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig,
                 scfg: Optional[StepConfig] = None,
                 ocfg: Optional[AdamWConfig] = None,
                 eval_loss_hook: bool = True,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> TrainReport:
    """Train ``cfg`` for ``tcfg.steps`` steps on ``device`` (``None`` = the
    card), resuming from the newest complete checkpoint in
    ``tcfg.ckpt_dir``."""
    dev = resolve_device(device)
    scfg = scfg or StepConfig(q_chunk=min(1024, shape.seq_len),
                              k_chunk=min(1024, shape.seq_len))
    ocfg = ocfg or AdamWConfig()
    report = TrainReport()

    step_fn, _ = build_train_step(cfg, shape, scfg, ocfg)
    sched_counts = step_fn.sched_counts
    eval_fn = build_eval_loss(cfg, scfg) if eval_loss_hook else None

    mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                            sched_policy=tcfg.ckpt_sched_policy,
                            stealing=tcfg.ckpt_stealing)
    # Train-step surface telemetry: the step's static schedule (microbatch
    # chunks + reduction buckets, planned by scfg.sched_policy) counted per
    # executed step; latencies are step wall times.
    step_tel = SchedTelemetry()
    data = SyntheticPipeline(DataConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        vocab=cfg.vocab, seed=tcfg.seed,
        n_shards=min(8, shape.global_batch)))

    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        _, state = mgr.restore(latest, device=dev)
        params, opt_state = state["params"], state["opt"]
        # restore dtypes (npy roundtrip keeps them; cast params to model dt)
        params = tree_map(lambda a, s: a.to(s.dtype), params,
                          MDL.param_shapes(cfg))
        start_step = latest
        report.resumed_from = latest
    else:
        params = MDL.init_params(
            cfg, torch.Generator(device=dev).manual_seed(tcfg.seed),
            device=dev)
        opt_state = init_opt_state(params, ocfg)

    times: list = []
    try:
        for step in range(start_step, tcfg.steps):
            # obs phases (cat="train"): data → eval → step → ckpt, one
            # span each per iteration so a trace shows what the wall time
            # of a training step is made of.
            with obs.trace_span("train", "data"):
                batch_np = data.batch_at(step)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch_np.items()}
                # the stubbed audio / vision frontends: zero frame or
                # patch embeddings, as the reference feeds them
                if cfg.family in ("encdec", "vlm"):
                    key, n = ("enc_frames", cfg.enc_seq) \
                        if cfg.family == "encdec" \
                        else ("vis_embed", cfg.vis_seq)
                    batch[key] = torch.zeros(
                        (shape.global_batch, n, cfg.d_model),
                        dtype=torch.bfloat16, device=dev)
            # monotonic step timing (straggler EWMA differences these;
            # time.time() can jump under NTP)
            t0 = time.perf_counter()
            if eval_fn is not None:
                with obs.trace_span("train", "eval"):
                    loss = float(eval_fn(params, batch))
                report.losses.append(loss)
            with obs.trace_span("train", "step", {"step": step}
                                if obs.enabled() else None):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            times.append(dt)
            report.step_times.append(dt)
            _MX_STEPS.inc()
            _MX_STEP_S.observe(dt)
            if report.losses:
                _MX_LOSS.set(report.losses[-1])
            step_tel.spawns += sched_counts["spawns"]
            step_tel.joins += sched_counts["joins"]
            # which arm executed the microbatches (run_loop semantics)
            if sched_counts["spawns"] > 0:
                step_tel.parallel_items += max(1, shape.microbatches)
            else:
                step_tel.serial_items += max(1, shape.microbatches)
            step_tel.record_latency(dt)
            report.grad_norms.append(float(metrics["grad_norm"]))
            _MX_GRAD_NORM.set(report.grad_norms[-1])
            # straggler detection
            if len(times) >= 5:
                med = float(np.median(times[-20:]))
                if dt > tcfg.straggler_factor * med:
                    report.stragglers += 1
                    _MX_STRAGGLERS.inc()
            if (step + 1) % tcfg.ckpt_every == 0 or step + 1 == tcfg.steps:
                with obs.trace_span("train", "ckpt", {"step": step + 1}
                                    if obs.enabled() else None):
                    mgr.save(step + 1,
                             {"params": params, "opt": opt_state},
                             blocking=(step + 1 == tcfg.steps))
            elif mgr.pending:
                # the previous step's save overlapped this step's compute;
                # join + publish now so the durability gap is one step,
                # not a whole checkpoint interval
                with obs.trace_span("train", "ckpt_wait"):
                    mgr.wait()
            report.completed = step + 1
            if tcfg.failure_at is not None and step + 1 == tcfg.failure_at:
                raise SimulatedFailure(
                    f"injected failure after step {step+1}")
        if sched_counts["escape_join"] and step_tel.spawns > 0:
            step_tel.joins += 1  # DCAFE: the single outer finish of the run
        report.sched = {
            "train_step": dict(policy=sched_counts["policy"],
                               mb_unroll=sched_counts["mb_unroll"],
                               **step_tel.summary()),
            "checkpoint": dict(policy=mgr.policy.name,
                               **mgr.telemetry.summary()),
        }
        return report
    finally:
        # close() waits on (and publishes) any pending save, then shuts
        # the I/O pool down — also on the failure-injection path.  If an
        # exception is already propagating, a failed pending publish must
        # not replace it (callers match on the primary error, e.g.
        # SimulatedFailure); data.stop() always runs.
        propagating = sys.exc_info()[0] is not None
        try:
            mgr.close()
        except Exception:
            if not propagating:
                raise
        finally:
            data.stop()
