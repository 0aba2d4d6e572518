"""The benchmark's harness: one cell, one run, one result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``benchmark/configs/<config>.json``, named by the entry of ``configs``)
under a traffic mix (``benchmark/traffic/<traffic>.json``). The mix names
its kind, a module ``benchmark/traffic/<kind>.py`` whose ``Cell`` makes
the data on the card from the seed, issues the calls and checks them
against its plain reference (``benchmark/reference/``). A per-layer
metric is a module ``benchmark/metrics/<metric>.py``. An end-to-end
metric's name up to its first dot says what it measures, and the rest
names the cells it is bounded over (``rows_per_s.host_paced`` is
``rows_per_s`` in the cells whose pace the host sets, which spread more).
A new cell, mix, kind or metric is a new file and a new entry: nothing
here changes.

One run: set-up (load the port and its kernels, make the data, warm the
cell's own call), then the window: a closed loop with one caller, who
issues a call, waits for its outputs and issues the next, for
``--seconds``. Then the peak memory is read, the program's state freed and
the answers compared with the reference; the result is the last line of
standard output, and the numbers compared, each beside its limit, are the
last lines of standard error.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
import traceback
from types import SimpleNamespace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
_MODULES: dict = {}


def load(subdir: str, name: str):
    """``benchmark/<subdir>/<name>.py`` as a module (a name may hold dots)."""
    key = (subdir, name)
    if key not in _MODULES:
        path = os.path.join(BENCH, subdir, name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no module {path}")
        mod_name = f"benchmark_{subdir}_{name}".replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(spec: dict, workload: str):
    """(workload entry, configuration data, traffic mix) of one cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    return (w, read_json(os.path.join(ROOT, cfg["file"])),
            read_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json")))


def metrics_of(spec: dict, section: str, workload: str) -> list:
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def make_cell(rt, config: dict, mix: dict, *, seed: int, device):
    kind = load("traffic", mix["kind"])
    return kind.Cell(rt, config, mix, seed=seed, device=device,
                     reference=load("reference", mix["reference"]))


def window(cell, seconds: float, max_calls: int | None = None,
           traced: bool = False):
    """The closed loop. Returns (latencies in s, window seconds, failed
    calls): every call issued before the deadline completes, and the
    window ends when the last one has."""
    import torch

    lat = []
    failed = 0
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function("bench.call"):
                    out = cell.call(i)
            else:
                out = cell.call(i)
        except Exception:  # a failed call is counted; the window ends
            traceback.print_exc(file=sys.stderr)
            failed += 1
            break
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        last = t1 >= deadline or (max_calls is not None and i + 1 >= max_calls)
        cell.keep(i, out, last)
        del out
        i += 1
        if last:
            break
    return lat, time.perf_counter() - start, failed


def p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def run_cell(rt, workload: dict, config: dict, mix: dict, *, seed: int,
             seconds: float, trace: bool, device, t0: float,
             metrics: list = (), control: str | None = None) -> dict:
    """Set-up, window and check of one run. Returns the result dict (the
    result line's keys, with ``checks`` last)."""
    import torch

    on_card = device.type == "cuda"
    cell = make_cell(rt, config, mix, seed=seed, device=device)
    if on_card:  # the generator's temporaries are not the program's
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    if control is not None:
        cell.use_control(control)
    cell.warm()
    sync(device)
    setup_s = time.monotonic() - t0

    ctx = SimpleNamespace(rt=rt, layer=cell.layer, state={}, trace=None,
                          calls=0, window_s=0.0, on_card=on_card,
                          hbm_bytes_per_s=None)
    readers = [(m, load("metrics", m["name"])) for m in metrics] if trace \
        else []
    for _, mod in readers:
        if hasattr(mod, "start"):
            mod.start(ctx)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                          else [])
        with profile(activities=acts) as prof:
            lat, window_s, failed = window(cell, seconds, mix["trace_calls"],
                                           traced=True)
            sync(device)
    else:
        lat, window_s, failed = window(cell, seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    calls = len(lat)

    result: dict = {"correct": False, "attempted": calls + failed,
                    "failed": failed, "metrics": {}}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": card,
           "count": workload["chips"], "memory_peak_bytes": peak}
    if trace:
        from tracing import Trace

        tr = Trace(prof)
        if on_card and not tr.ops:
            raise RuntimeError("the profiler saw no device op in the window")
        ctx.trace, ctx.calls, ctx.window_s = tr, tr.calls, tr.window_us / 1e6
        if on_card:
            from peaks import hbm_bytes_per_s

            ctx.hbm_bytes_per_s = hbm_bytes_per_s(card)
        for m, mod in readers:
            value = mod.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.window_us / 1e6
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        del prof, tr
    elif calls:
        e2e = {"rows_per_s": calls * cell.rows / window_s,
               "call_p95_ms": p95(lat) * 1e3,
               "peak_mem_per_row": peak / cell.rows,
               "setup_s": setup_s}
        for m in metrics:  # rows_per_s.host_paced measures rows_per_s
            base = m["name"].split(".")[0]
            if base in e2e:
                result["metrics"][m["name"]] = {"value": e2e[base],
                                                "unit": m["unit"]}
        result["calls"] = calls
    result["device"] = dev

    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = cell.check() if calls else {}
    result["correct"] = bool(calls) and not failed and all(
        v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    del cell
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def main(workload: str, seed: int, seconds: float, trace: bool,
         t0: float) -> int:
    spec = benchmark_spec()
    w, config, mix = cell_spec(spec, workload)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "bench_cache",
                                                  "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "bench_cache",
                                                      "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: {workload} needs {w['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import peaks
    import port

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rt = port.load(ROOT)
    build = port.build_kernels()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    section = "per_layer" if trace else "end_to_end"
    result = run_cell(rt, w, config, mix, seed=seed, seconds=seconds,
                      trace=trace, device=device, t0=t0,
                      metrics=metrics_of(spec, section, workload))
    checks = result.pop("checks")
    result["build"] = build
    result["power"] = peaks.power_limit()
    result["checks"] = checks
    if "calls" in result:
        print(f"calls {result['calls']}: the samples of call_p95_ms")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
