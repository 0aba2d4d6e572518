"""Timing on the card — counterpart of ``cuda/radixsort_tpu/utils/profiling.py``.

Only a CUDA-event timer: the median of ``runs`` timed calls after
``warmup`` untimed ones. Each call is bracketed by its own pair of events
on the current stream, so the time is the device's, not the host's enqueue.
"""

from __future__ import annotations

import statistics

import torch


def cuda_time_ms(fn, *, runs: int = 5, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn()`` over ``runs`` calls. Raises
    without a card: there is no host-clock fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    if runs < 1:
        raise ValueError("runs must be >= 1")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)
