"""The trace reduction on a made-up profiler run: device ops tied to the
ranges open at their launching runtime call, the window made of the
calls' own time, idle gaps named by what the host was doing."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from tracing import Trace


class Ev:
    def __init__(self, name, start, end, *, dev=False, corr=0, ann=False):
        self._v = (name, start * 1000, end * 1000, dev, corr, ann)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self._v[5]


def trace(events):
    results = SimpleNamespace(trace_start_ns=lambda: 0, events=lambda: events)
    return Trace(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=results)))


EVENTS = [  # times in microseconds
    Ev("bench.call", 0, 100, ann=True),
    Ev("Query.run", 1, 90, ann=True),
    Ev("join", 10, 60, ann=True),
    Ev("aten::cat", 11, 15),
    Ev("cudaLaunchKernel", 12, 13, corr=7),  # torch glue in join
    Ev("cudaLaunchKernel", 20, 21, corr=8),  # the port's kernel, via ctypes
    Ev("cudaLaunchKernel", 70, 71, corr=9),  # the plan's own glue
    Ev("cudaMemcpyAsync", 80, 95, corr=10),
    Ev("bench.call", 200, 300, ann=True),  # between calls: the harness
    Ev("cudaMemcpyAsync", 150, 160, corr=11),
    Ev("cat_kernel", 14, 30, dev=True, corr=7),
    Ev("stage_onesweep<32>", 30, 70, dev=True, corr=8),
    Ev("elementwise", 72, 80, dev=True, corr=9),
    Ev("Memcpy DtoH", 81, 82, dev=True, corr=10),
    Ev("Memcpy DtoH", 151, 190, dev=True, corr=11),
    Ev("Query.run", 14, 90, dev=True, ann=True),  # a range's device copy
]


def test_device_ops_carry_the_ranges_open_at_their_launch():
    tr = trace(EVENTS)
    by_name = {op.name: op.ranges for op in tr.ops}
    assert by_name == {
        "cat_kernel": ("join", "Query.run", "bench.call"),
        "stage_onesweep<32>": ("join", "Query.run", "bench.call"),
        "elementwise": ("Query.run", "bench.call"),
        "Memcpy DtoH": ("Query.run", "bench.call")}
    assert tr.calls == 2 and tr.outside == 1 and tr.unlinked == 0


def test_the_window_is_the_calls_own_time():
    tr = trace(EVENTS)
    assert tr.window_us == 200
    assert tr.busy_us() == (70 - 14) + (80 - 72) + (82 - 81)
    gaps = dict(tr.idle_gaps())
    assert abs(sum(gaps.values()) - (200 - tr.busy_us()) / 1e6) < 1e-12
    want = {"bench.call > -": 14 + 100,  # the second call ran nothing
            "Query.run > cudaLaunchKernel": 2,
            "Query.run > cudaMemcpyAsync": 1 + 18}
    assert gaps.keys() == want.keys()
    assert all(abs(gaps[k] - us / 1e6) < 1e-12 for k, us in want.items())
