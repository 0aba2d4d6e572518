"""Timing on the card — counterpart of ``cuda/radixsort_tpu/utils/profiling.py``.

Two CUDA-event timers. :func:`cuda_time_ms` brackets each call with its
own pair of events on the current stream: the time a caller waits for one
call, which includes the host's launch path wherever the card waits for it
(a kernel shorter than its wrapper's Python is timed as the wrapper).
:func:`device_time_ms` times batches of back-to-back calls queued behind a
spin kernel, so the card never waits for the host: the card's own time per
call, the gaps between its launches included.
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


def device_time_ms(fn, *, runs: int = 5, calls: int = 10, warmup: int = 2,
                   lead_ms: float = 4.0) -> float:
    """Median device milliseconds per call of ``fn()`` over ``runs``
    batches of ``calls`` calls. Each batch is enqueued behind a
    ``torch.cuda._sleep`` kernel of at least ``lead_ms`` (cycles at 2 GHz,
    above the card's clock); if the card reached the batch before the host
    had queued it all, the lead is doubled and the batch timed again."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device")
    if runs < 1 or calls < 1:
        raise ValueError("runs and calls must be >= 1")
    for _ in range(warmup):
        fn()
    times = []
    while len(times) < runs:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(lead_ms * 2e6))
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        if start.query():  # the card waited for the host: time it again
            stop.synchronize()
            lead_ms *= 2
            if lead_ms > 1000:
                raise RuntimeError("device_time_ms: the calls wait for the "
                                   "card (a host sync?); use cuda_time_ms")
            continue
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)
