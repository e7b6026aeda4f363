"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``: the same flags and the same JSON keys,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain kernels).
Runs real steps on one device: smoke configs anywhere, full widths on the
card as far as they fit (granite-moe-1b-a400m does).
"""

from __future__ import annotations

import argparse
import json

from ..configs import ARCH_IDS, get_config
from ..configs.base import ShapeConfig
from ..train.optimizer import AdamWConfig
from ..train.train_step import POLICIES, StepConfig
from ..train.trainer import TrainerConfig, run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--policy", default="afe", choices=POLICIES)
    ap.add_argument("--sched-policy", default="dlbc",
                    choices=("serial", "lc", "dlbc", "dcafe"),
                    help="repro_torch.sched policy scheduling the train "
                         "step (microbatch chunks + gradient buckets)")
    ap.add_argument("--ckpt-sched-policy", default="dcafe",
                    choices=("serial", "lc", "dlbc", "dcafe"),
                    help="repro_torch.sched policy for checkpoint shard "
                         "writes")
    ap.add_argument("--ckpt-dir", default=TrainerConfig.ckpt_dir)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--failure-at", type=int, default=None)
    ap.add_argument("--telemetry-json", default=None,
                    help="also dump the per-surface sched telemetry here")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record an obs span trace of the run and write "
                         "Chrome trace-event JSON here (Perfetto-loadable)")
    ap.add_argument("--metrics-json", default=None, metavar="OUT.jsonl",
                    help="stream windowed metrics-registry snapshots "
                         "(JSON lines, one delta per interval) here")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="snapshot interval in seconds for --metrics-json")
    args = ap.parse_args(argv)

    if args.trace:
        from ..obs import trace as obs_trace
        obs_trace.enable()
    snapshotter = None
    if args.metrics_json:
        from ..obs.metrics import Snapshotter
        snapshotter = Snapshotter(interval_s=args.metrics_interval,
                                  path=args.metrics_json)
        snapshotter.start()

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train",
                        microbatches=args.microbatches)
    scfg = StepConfig(policy=args.policy, sched_policy=args.sched_policy,
                      q_chunk=min(512, args.seq_len),
                      k_chunk=min(512, args.seq_len),
                      ssm_chunk=min(128, args.seq_len))
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, failure_at=args.failure_at,
                         ckpt_sched_policy=args.ckpt_sched_policy)
    try:
        rep = run_training(cfg, shape, tcfg, scfg, AdamWConfig(),
                           device=args.device)
    finally:
        if snapshotter is not None:
            snapshotter.stop()
    out = {
        "arch": cfg.name, "completed": rep.completed,
        "resumed_from": rep.resumed_from,
        "first_loss": rep.losses[0] if rep.losses else None,
        "last_loss": rep.losses[-1] if rep.losses else None,
        "stragglers": rep.stragglers,
        "mean_step_s": sum(rep.step_times) / max(1, len(rep.step_times)),
        # Fig. 10-comparable spawn/join telemetry per execution surface
        "sched": rep.sched,
    }
    print(json.dumps(out, indent=1))
    if args.telemetry_json:
        with open(args.telemetry_json, "w") as f:
            json.dump(rep.sched, f, indent=1)
    if args.trace:
        from ..obs import export as obs_export
        obs_export.write_chrome_trace(args.trace,
                                      extra={"telemetry": rep.sched})
        print(f"[trace written to {args.trace}]")
    return out


if __name__ == "__main__":
    main()
