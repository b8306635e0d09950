"""Timing one call at a time at a public entry of the program, by CUDA
events on the card, the median of a few calls after a warm-up."""
from __future__ import annotations

import statistics
from typing import Callable


def median_seconds(fn: Callable[[], object], reps: int = 7,
                   warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e-3)
    return statistics.median(times)
