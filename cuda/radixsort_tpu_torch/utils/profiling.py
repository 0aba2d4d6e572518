"""Measurement on the card — counterpart of ``cuda/radixsort_tpu/utils/profiling.py``.

Timers, all with CUDA events and none with a host-clock fallback:
:func:`cuda_time_ms` brackets each call with its own pair of events on
the current stream: the time a caller waits for one call, which includes
the host's launch path wherever the card waits for it (a kernel shorter
than its wrapper's Python is timed as the wrapper). :func:`device_time_ms`
times batches of back-to-back calls queued behind a spin kernel, so the
card never waits for the host: the card's own time per call, the gaps
between its launches included. :func:`timed_calls` and
:func:`timed_chain` keep the JAX module's return shapes.

The roofline: :data:`HBM_BYTES_PER_S` (the card's memory rate, by name),
:func:`speed_of_light`, and the network's bytes model
:func:`bitonic_passes` / :func:`bitonic_sort_bytes`, counted from the
schedule the kernels run.

Tracing: :func:`trace` writes a ``torch.profiler`` Chrome trace;
:func:`traced` opens a ``record_function`` range under an operator's
name, so the port's operators, the ``parallel/`` entry points and
``Query.run``'s stages show in a trace as the JAX functions' jitted names
show in theirs.
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics

import torch

from cuda.radixsort_tpu_torch.utils import build

# The card's memory rate, keyed by torch.cuda.get_device_name(): NVIDIA's
# data sheet for the H100 SXM. No default: a card not listed here must be
# added with its own data sheet's rate.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# trace()'s default directory, beside the kernels' build under build/
TRACE_DIR = os.path.join(os.path.dirname(build.BUILD_DIR), "trace")


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")


def cuda_time_ms(fn, *, runs: int = 5, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn()`` over ``runs`` calls. Raises
    without a card: there is no host-clock fallback."""
    _require_card("cuda_time_ms")
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
    _require_card("device_time_ms")
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


def _sync_leaf(out) -> None:
    """Wait for the first tensor of a call's output (a tensor, or the first
    leaf of a tuple, list or dict of them), as JAX's timers fetch one."""
    while isinstance(out, (tuple, list, dict)):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    if isinstance(out, torch.Tensor):
        out.reshape(-1)[:1].sum().item()


def timed_calls(fn, args, m: int = 4) -> dict:
    """Seconds per call of ``fn(*args)``, each call waited for by fetching
    one element of its output, as a caller waits. A no-op's call and fetch
    is timed the same way and reported as ``sync_overhead_s``; ``seconds``
    is the call's time less it, ``raw_seconds`` the call's as measured.
    CUDA events on the current stream; raises without a card."""
    _require_card("timed_calls")
    if m < 1:
        raise ValueError("m must be >= 1")
    noop = torch.zeros(1, dtype=torch.int32, device="cuda")

    def per_call(call) -> float:
        call()  # warm
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(m):
            call()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / m

    overhead = per_call(lambda: _sync_leaf(noop + 0))
    raw = per_call(lambda: _sync_leaf(fn(*args)))
    return {"seconds": max(raw - overhead, 1e-9),
            "sync_overhead_s": overhead, "raw_seconds": raw}


def timed_chain(step, x0, k: int = 6) -> float:
    """Seconds per ``step(x)`` in a chain x -> step(x) -> ...: the
    difference of a 3k-step and a k-step chain over 2k steps, which
    cancels the chain's fixed cost. ``step`` maps x to a tensor of its
    shape (rotate the bits so each step sees fresh data). CUDA events on
    the current stream; raises without a card."""
    _require_card("timed_chain")
    if k < 1:
        raise ValueError("k must be >= 1")

    def chain(steps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        x = x0
        for _ in range(steps):
            x = step(x)
        _sync_leaf(x)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3

    chain(1)  # warm
    short, long = chain(k), chain(3 * k)
    return max((long - short) / (2 * k), 1e-9)


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR):
    """Profile the block with ``torch.profiler``: CPU activity, and CUDA
    activity where a card is present. On exit a Chrome trace
    (``trace.json``) is written into ``log_dir``, which is yielded. The
    port's operators show in it as ranges under their names
    (:func:`traced`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def traced(fn):
    """Decorator: run ``fn`` inside a ``torch.profiler.record_function``
    range named after it (its qualified name, the JAX function's name: a
    method's is 'Query.run'), so a trace splits the torch ops and kernels
    under each operator. The signature and docstring stay ``fn``'s
    (``functools.wraps``)."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


def bitonic_passes(logn: int, n_planes: int = 1) -> int:
    """Memory round trips of a network sort of 2^logn rows of ``n_planes``
    u32 planes: the launches of the schedule the kernels run
    (``kernels/bitonic.py::plan_passes``: one tile pass for the levels
    inside a tile, then per level its cross passes and a tile pass). Each
    reads and writes every plane once.

    JAX's ``log_tile`` and ``log_merge`` are not taken: the first sets the
    network's order of ties, not its passes, and the second is the TPU
    merge kernel's VMEM block, which the port does not have."""
    from cuda.radixsort_tpu_torch.kernels import bitonic

    return len(bitonic.plan_passes(logn, 1, n_planes))


def bitonic_sort_bytes(n: int, n_planes: int = 1) -> int:
    """Memory bytes a network sort of n rows x ``n_planes`` u32 planes
    moves: every pass of :func:`bitonic_passes` reads and writes each
    plane of the padded 2^max(bitlen(n - 1), 10) rows (``ops/sort.py``'s
    padding)."""
    logn = max((n - 1).bit_length(), 10)
    return bitonic_passes(logn, n_planes) * 8 * n_planes * (1 << logn)


def speed_of_light(bytes_moved: float, seconds: float,
                   hbm_bytes_per_s: float | None = None) -> dict:
    """The share of the memory rate a call achieved: ``bytes_moved``
    (reads and writes, e.g. one radix pass over N u32 keys = 2 * 4 * N)
    over ``seconds``. The rate defaults to the card's
    (:data:`HBM_BYTES_PER_S`); raises without a card or for a card not in
    that table."""
    bw = hbm_bytes_per_s
    if bw is None:
        _require_card("speed_of_light without hbm_bytes_per_s")
        name = torch.cuda.get_device_name()
        if name not in HBM_BYTES_PER_S:
            raise KeyError(f"no memory rate for {name!r} in HBM_BYTES_PER_S;"
                           " pass hbm_bytes_per_s")
        bw = HBM_BYTES_PER_S[name]
    achieved = bytes_moved / seconds
    return {"achieved_bytes_per_s": achieved, "hbm_bytes_per_s": bw,
            "fraction_of_sol": achieved / bw}
