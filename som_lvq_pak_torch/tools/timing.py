"""The tools' device and clock: CUDA events on a card, the host clock on the
CPU (a CPU time, never a device number)."""

from __future__ import annotations

import time
from typing import Callable, Union

import torch


def resolve(device: Union[torch.device, str]) -> torch.device:
    """`device` as a torch.device; "cuda" without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the tools measure the card; "
                           "pass device='cpu' to run the plain versions")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mean_ms(fn: Callable[[], object], dev: torch.device, iters: int = 10) -> float:
    """Mean milliseconds per call of fn() over `iters` calls after one
    warm-up call."""
    fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters
