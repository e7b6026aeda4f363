"""The few device calls the harness makes, which are no-ops on the CPU
(the CPU tests drive the harness with the kernels' plain versions)."""

from __future__ import annotations

import torch


def on_card() -> bool:
    return torch.cuda.is_available()


def sync() -> None:
    if on_card():
        torch.cuda.synchronize()


def reset_peak() -> None:
    if on_card():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return int(torch.cuda.max_memory_allocated()) if on_card() else 0


def free() -> None:
    import gc

    gc.collect()
    if on_card():
        torch.cuda.empty_cache()
