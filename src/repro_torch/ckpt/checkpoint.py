"""Sharded, asynchronous, fault-tolerant checkpointing.

Port of ``repro/ckpt/checkpoint.py``, with the reference's on-disk layout
(``step_<n>/shard_<proc>_<i>.npy`` plus ``manifest_<proc>.json`` and a
``COMMIT`` marker), so a checkpoint written by either package restores in
the other.  Trees are nested dicts of torch tensors; bf16 travels as a
``uint16`` view with the logical dtype in the manifest, as
:mod:`repro_torch.bridge` does (no ``ml_dtypes`` needed).  One process
writes every shard (``proc`` 0) until the port has a mesh (ROADMAP Queue 1
item 11), which also brings the resharding restore.

Design (multi-host-shaped, exercised single-host here):

* each host writes only its **addressable shards**
  as ``<step>/shard_<proc>_<i>.npy`` files plus a pytree manifest;
* writes go to a temp dir, fsync'd, then atomically renamed —
  a crash mid-write never corrupts the latest checkpoint
  (the trainer's restore scans for the newest *complete* step);
* saving is asynchronous and scheduled by ``repro_torch.sched``: the
  tensors are snapshotted to host memory in the trainer thread (a copy:
  the optimizer updates its tensors in place), then the per-shard file
  writes run on a
  :class:`repro_torch.sched.executors.ThreadExecutor` under the manager's
  scheduling policy.  Under the default DCAFE policy the spawned write
  chunks escape their per-loop join into a :class:`FinishScope` — one
  join per ``save``, performed by :meth:`wait`, so the train loop overlaps
  with the I/O and the atomic publish happens at the join;
* restore reassembles the tensors logically and places them on the
  device it is given.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as obs
from ..sched import (
    FinishScope, MultipleExceptions, RetryPolicy, SchedTelemetry,
    TaskError, ThreadExecutor, WorkStealingExecutor, get_policy,
)
from ..sched import faults


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 executor: Optional[ThreadExecutor] = None,
                 sched_policy: str = "dcafe", n_io_workers: int = 4,
                 stealing: bool = False,
                 retry: Optional[RetryPolicy] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.policy = get_policy(sched_policy)
        #: per-shard write retries: a transiently failing shard retries
        #: (bounded, deterministic backoff keyed by shard index) without
        #: aborting the save; only exhausted retries fail the publish.
        self.retry = retry if retry is not None else RetryPolicy(attempts=3)
        # The I/O pool is created lazily on the first save: restore-only
        # managers never spawn threads, and close() is only needed once
        # a save has run.
        self._own_executor = executor is None
        self._ex = executor
        self._n_io_workers = n_io_workers
        # Adaptive work stealing for shard writes: ranges split on steal
        # when shard sizes skew, grain comes from the policy's
        # GrainController (no grain arithmetic on this surface).
        self._stealing = stealing
        self.telemetry = executor.telemetry if executor is not None \
            else SchedTelemetry()
        self._scope: Optional[FinishScope] = None
        self._finalize: Optional[Callable[[], None]] = None

    @property
    def executor(self) -> ThreadExecutor:
        if self._ex is None:
            cls = WorkStealingExecutor if self._stealing else ThreadExecutor
            self._ex = cls(n_workers=self._n_io_workers,
                           telemetry=self.telemetry)
            if self._own_executor:
                # a dropped manager must not leak its worker threads even
                # if the caller never reached close()
                weakref.finalize(self, self._ex.shutdown)
        return self._ex

    @property
    def pending(self) -> bool:
        """A non-blocking save is awaiting its join/publish."""
        return self._scope is not None or self._finalize is not None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: dict, *, blocking: bool = False):
        """Snapshot to host, then write shards through the scheduler.

        Returns once the shard writes are *scheduled* (plus whatever chunk
        the DCAFE plan keeps on the caller); the checkpoint is published
        atomically by :meth:`wait` — exactly one join per save.  A
        non-blocking save is therefore NOT durable until the next
        ``wait()``/``save()``/``close()`` — callers wanting overlap with
        bounded exposure should ``wait()`` shortly after (the trainer
        does so one step later, once the I/O has had a step to finish).
        """
        with obs.trace_span("ckpt", "snapshot", {"step": step}
                            if obs.enabled() else None):
            snap = {}
            for path, arr in _flatten_with_paths(tree):
                snap[path] = _to_host(arr)  # device→host copy now
        self.wait()
        self._scope = FinishScope(self.telemetry) \
            if self.policy.escape_join else None
        self._finalize = self._write(step, snap, self._scope)
        if blocking:
            self.wait()

    def wait(self):
        """Join the pending save (ONE join — the escaped finish) and
        atomically publish it.  Shard failures collected by the scope
        (after their per-shard retries were exhausted) surface HERE, as
        the publish's ``RuntimeError`` — a failed shard can never be
        COMMITted, and the temp dir is left un-published for forensics.
        """
        scope_errors = []
        if self._scope is not None:
            scope, self._scope = self._scope, None
            out = scope.wait()  # non-raising: publish reports, once
            if out.failed:
                scope_errors = list(out.errors)
        if self._finalize is not None:
            # cleared before the call: a failed publish raises once, not
            # on every subsequent wait()/close()
            fin, self._finalize = self._finalize, None
            fin(scope_errors)

    def close(self):
        try:
            self.wait()
        finally:
            # a failed pending publish must not leak the I/O pool
            if self._own_executor and self._ex is not None:
                self._ex.shutdown()
                self._ex = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _write(self, step: int, snap: dict, scope: Optional[FinishScope]):
        """Schedule the shard writes; return the publish closure.

        The manifest is fully determined by the snapshot, so it is built
        up front and only the ``np.save`` calls — the actual I/O — run as
        scheduled tasks.
        """
        proc = _PROC
        tmp = self.dir / f"tmp_{step}_{proc}_{os.getpid()}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        shard_jobs = []
        for i, (path, (arr, logical_dtype)) in enumerate(sorted(snap.items())):
            fname = f"shard_{proc}_{i}.npy"
            manifest[path] = {"file": fname, "shape": list(arr.shape),
                              "dtype": logical_dtype}
            # the shard index rides along as the retry jitter key — a
            # stable int, never hash(filename) (salted per process)
            shard_jobs.append((tmp / fname, arr, i))

        # A transiently failing shard retries in place (bounded backoff,
        # without aborting the sibling writes); only exhausted retries
        # fail the shard, and those are CONTAINED here — collected under
        # a lock regardless of whether the shard ran on a worker or on
        # the caller's chunk (caller items would otherwise propagate raw
        # and abort the loop mid-save) — then re-checked by publish() so
        # a failed shard can never be COMMITted.
        collected = []  # TaskErrors from exhausted per-shard retries
        collected_lock = threading.Lock()

        def write_shard(job):
            fname, arr, idx = job

            def attempt():
                plan = faults.active()
                if plan is not None:
                    plan.poke("ckpt.shard")
                with obs.trace_span("ckpt", "shard_write",
                                    {"bytes": int(arr.nbytes)}
                                    if obs.enabled() else None):
                    np.save(fname, arr)

            try:
                self.retry.run(attempt, key=idx, site="ckpt.shard",
                               telemetry=self.telemetry)
            except Exception as e:
                with collected_lock:
                    collected.append(TaskError(
                        exc=e, site="ckpt.shard", lo=idx, hi=idx + 1,
                        tb=traceback.format_exc()))

        try:
            self.executor.run_loop(shard_jobs, write_shard,
                                   policy=self.policy, scope=scope)
        except MultipleExceptions as e:
            # defensive: write_shard contains its own failures, but any
            # error a join still surfaces must reach publish identically
            collected.extend(e.errors)

        def publish(scope_errors=()):
            errors = collected + list(scope_errors)
            if errors:
                err = errors[0]
                raise RuntimeError(
                    f"checkpoint step {step}: {len(errors)} shard "
                    f"write(s) failed after retries "
                    f"(first: {err.summary()}); "
                    "leaving the un-COMMITted temp dir") from err.exc
            with obs.trace_span("ckpt", "publish", {"step": step}
                                if obs.enabled() else None):
                (tmp / f"manifest_{proc}.json").write_text(
                    json.dumps(manifest))
                # wall-clock commit timestamp on purpose (it is read by
                # humans across restarts, not differenced)
                (tmp / "COMMIT").write_text(str(time.time()))
                # Atomic publish.
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()

        return publish

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():  # complete checkpoints only
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None) -> tuple:
        """Returns (step, tree) with the tensors on ``device`` (``None`` =
        the card).  Placing them under a mesh sharding (the reference's
        elastic restart) waits for the port's mesh (item 11)."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / f"manifest_{_PROC}.json").read_text())
        items = {}
        for path, meta in manifest.items():
            arr = np.load(d / meta["file"])
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.astype(np.dtype(meta["dtype"]),
                                                copy=False))
            items[path] = t.to(dev)
        return step, _unflatten_from_paths(items)


#: the process index of the shard files: one process until item 11
_PROC = 0


def _to_host(t: torch.Tensor) -> tuple:
    """``(numpy copy, logical dtype name)``; bf16 as its ``uint16`` bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16).copy(), \
            "bfloat16"
    arr = t.cpu().numpy().copy()
    return arr, str(arr.dtype)


def _flatten_with_paths(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
    else:
        out.append((prefix, tree))
    return out


def _unflatten_from_paths(items: dict):
    root: dict = {}
    for path, val in items.items():
        keys = [k for k in path.split("/") if k]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return root
