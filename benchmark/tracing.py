"""A ``torch.profiler`` run reduced to what the per-layer metrics read.

Device work is every kernel, memcpy and memset the profiler saw on the
card; the device-side copies of host ranges (user annotations) and sync
records are not work. Each is tied to the host through the CUDA runtime
call that launched it (the same correlation id): the ``record_function``
ranges open at that call (the program's ``traced`` operators and query
stages, the harness's own ``bench.call``) are the ranges it ran under,
innermost first. The port's kernels are launched through ctypes, under
no torch op, so the runtime call is their only link to the host.

The window is the time the calls took: the ``bench.call`` ranges, each
from its issue until its outputs were on the host. The harness's own work
between calls (the copy of an answer it checks later) is not the
program's: device work launched outside every call is left out, and the
time between calls is not in the window.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

CALL_RANGE = "bench.call"


@dataclass
class DeviceOp:
    name: str
    start: float  # microseconds since the trace began
    end: float
    ranges: tuple  # host ranges it ran under, innermost first

    @property
    def us(self) -> float:
        return self.end - self.start


@dataclass
class _Host:
    name: str
    start: float
    end: float
    parent: int = -1  # the innermost range around it, for a range


def _end_ns(e) -> int:
    return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()


def _annotation(e) -> bool:
    return bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") \
        else None


def _runtime(name: str) -> bool:
    return name.startswith("cu") and "::" not in name


class Trace:
    """Device ops of one traced window, each with its host ranges."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        results = prof.profiler.kineto_results
        t0 = results.trace_start_ns()
        ranges, ops, runtime, dev_raw = [], [], {}, []
        call_thread = None
        for e in results.events():
            name = e.name()
            start, end = (e.start_ns() - t0) / 1e3, (_end_ns(e) - t0) / 1e3
            ann = _annotation(e)
            if e.device_type() == DeviceType.CPU:
                if ann or (ann is None and not name.startswith("aten::")
                           and not _runtime(name)):
                    ranges.append((_Host(name, start, end),
                                   e.start_thread_id()))
                    if name == CALL_RANGE:
                        call_thread = e.start_thread_id()
                elif _runtime(name):
                    runtime[e.correlation_id()] = start
                    ops.append(_Host(name, start, end))
                else:
                    ops.append(_Host(name, start, end))
            elif not ann and "Sync" not in name:
                dev_raw.append((name, start, end, e.correlation_id()))
        # the harness's thread issues every call
        self.ranges = sorted((h for h, th in ranges if call_thread is None
                              or th == call_thread),
                             key=lambda h: (h.start, -h.end))
        _nest(self.ranges)
        self._starts = [h.start for h in self.ranges]
        self.host_ops = sorted(ops, key=lambda h: (h.start, -h.end))
        calls = [h for h in self.ranges if h.name == CALL_RANGE]
        self.calls = len(calls)
        if calls:
            self.spans = [(h.start, h.end) for h in calls]
        else:
            self.spans = [(min((d[1] for d in dev_raw), default=0.0),
                           max((d[2] for d in dev_raw), default=0.0))]
        lo, hi = self.spans[0][0], self.spans[-1][1]
        self.ops = []  # the program's: launched inside a call
        self.outside = 0  # device ops launched between calls
        self.unlinked = 0  # device ops with no launching runtime call
        for name, start, end, corr in dev_raw:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            launched = runtime.get(corr)
            if launched is None:
                self.unlinked += 1
            names = self.ranges_at(launched) if launched is not None else ()
            if calls and CALL_RANGE not in names:
                self.outside += 1
                continue
            self.ops.append(DeviceOp(name, start, end, names))
        if calls and dev_raw and not self.ops:
            raise RuntimeError("no device op of the window could be tied to "
                               "a call: the profiler's links are missing")

    def _innermost(self, t: float) -> int:
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.ranges[i].end < t:
            i = self.ranges[i].parent
        return i

    def ranges_at(self, t: float) -> tuple:
        """Names of the host ranges open at time t, innermost first."""
        names, i = [], self._innermost(t)
        while i >= 0:
            names.append(self.ranges[i].name)
            i = self.ranges[i].parent
        return tuple(names)

    @property
    def window_us(self) -> float:
        return sum(e - s for s, e in self.spans)

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals, in time order."""
        out = []
        for s, e in sorted((op.start, op.end) for op in self.ops):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def top_device_ops(self, k: int = 10) -> list:
        """[[name, seconds], ...]: the device ops that took most time."""
        by_name: dict = {}
        for op in self.ops:
            name = _short(op.name)
            by_name[name] = by_name.get(name, 0.0) + op.us / 1e6
        return _top(by_name, k)

    def idle_gaps(self, k: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: the device's idle
        time inside the calls, summed by the innermost host range and the
        innermost torch op or runtime call open when each gap began."""
        gaps, busy, j = [], self.busy_intervals(), 0
        for lo, hi in self.spans:  # each call's time the card was idle
            last = lo
            while j < len(busy) and busy[j][1] <= lo:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < hi:
                if busy[k][0] > last:
                    gaps.append((last, busy[k][0]))
                last = max(last, busy[k][1])
                k += 1
            if hi > last:
                gaps.append((last, hi))
        by_what: dict = {}
        stack: list = []
        j = 0
        for s, e in gaps:
            while j < len(self.host_ops) and self.host_ops[j].start <= s:
                stack.append(self.host_ops[j])
                j += 1
            stack = [h for h in stack if h.end > s]
            rng = self.ranges_at(s)
            what = f"{rng[0] if rng else '-'} > " \
                   f"{stack[-1].name if stack else '-'}"
            what = _short(what, 120)
            by_what[what] = by_what.get(what, 0.0) + (e - s) / 1e6
        return _top(by_what, k)


def _nest(ranges: list) -> None:
    """Set each range's innermost enclosing range (sorted by start)."""
    stack: list = []
    for i, h in enumerate(ranges):
        while stack and ranges[stack[-1]].end <= h.start:
            stack.pop()
        h.parent = stack[-1] if stack else -1
        stack.append(i)


def _top(totals: dict, k: int) -> list:
    return [[n, s] for n, s in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:k]]


def _short(name: str, n: int = 80) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if "(" in name and not name.startswith("("):
        name = name.split("(")[0]
    return name[:n]
