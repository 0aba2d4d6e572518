"""The out-of-core cell (``external_sort_u32_2e30``) on the CPU at 2^16 keys
in 2^12-row chunks (16 runs merged on the host), the kernels' plain
versions sorting the chunks: ``correct`` holds for the program and fails
for the control (the runs left unmerged) and for each fault planted in the
timed path (the input handed back unchanged, one run left out of the
merge, the caller's array sorted in place, one row altered in the merge's
output); and a traced run reads the out-of-core layer's metrics. The
control is also run on the card at the cell's own size (``seeds.py
--control``; PERF.md gives the readings).
"""

import importlib
import time

import numpy as np
import pytest
import torch

import harness

CELL = "external_sort_u32_2e30"
SEED = 2**31 + 31
SIZE = {"rows": 1 << 16, "chunk": 1 << 12}


def run(rt, control: str | None = None, trace: bool = False) -> dict:
    """One run; a traced one reads the cell's per-layer metrics but the
    device's, which need a card."""
    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, CELL)
    cfg, mix = dict(cfg, **SIZE), dict(mix, check_pool=2, **SIZE)
    metrics = harness.metrics_of(spec, "per_layer" if trace
                                 else "end_to_end", CELL)
    if trace:
        metrics = [m for m in metrics if not m["name"].startswith("device.")]
    return harness.run_cell(rt, w, cfg, mix, seed=SEED, seconds=0.3,
                            trace=trace, device=torch.device("cpu"),
                            t0=time.monotonic(), metrics=metrics,
                            control=control)


def checks(result: dict) -> tuple:
    c = result["checks"]
    return c["mismatched_rows"]["value"], c["input_changed_rows"]["value"]


def test_the_program_is_correct(rt):
    r = run(rt)
    assert r["correct"] and checks(r) == (0, 0) and r["calls"] >= 1
    assert set(r["metrics"]) == {"rows_per_s.host_paced",
                                 "call_p95_ms.host_paced", "peak_mem_per_row",
                                 "setup_s"}


def test_the_control_is_not_correct(rt):
    control = harness.cell_spec(harness.benchmark_spec(), CELL)[2]["control"]
    r = run(rt, control)
    mismatched, changed = checks(r)
    assert not r["correct"] and mismatched > 0 and changed == 0


def _fault(rt, kind: str):
    """(object, attribute, faulty replacement) in the timed path."""
    native = importlib.import_module("cuda.radixsort_tpu_torch.utils.native")
    merge = native.kway_merge_u32
    good = rt.sort_external
    if kind == "unchanged":  # the caller's keys handed back as they came
        return rt, "sort_external", lambda keys, **kw: keys
    if kind == "run_left_out":
        return native, "kway_merge_u32", lambda runs, *a, **kw: merge(
            runs[:-1], *a, **kw)
    if kind == "sorted_in_place":

        def in_place(keys, **kw):
            keys[:] = good(keys, **kw)
            return keys

        return rt, "sort_external", in_place

    def altered(runs, *a, **kw):  # one row of the merged keys altered
        out = merge(runs, *a, **kw)
        out[out.shape[0] // 3] ^= np.uint32(1)
        return out

    return native, "kway_merge_u32", altered


@pytest.mark.parametrize("kind", ["unchanged", "run_left_out",
                                  "sorted_in_place", "altered"])
def test_a_fault_in_the_timed_path_is_not_correct(rt, monkeypatch, kind):
    monkeypatch.setattr(*_fault(rt, kind))
    r = run(rt)
    mismatched, changed = checks(r)
    assert not r["correct"]
    if kind == "sorted_in_place":
        assert changed > 0
    else:
        assert mismatched > 0


def test_the_traced_run_reads_the_out_of_core_layer(rt):
    r = run(rt, trace=True)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    # no Memcpy op runs on the CPU: the link's share reads nothing
    assert set(got) == {"external.merge_pct", "external.copy_pct"}
    assert all(0 <= v <= 100 for v in got.values())
    assert got["external.merge_pct"] + got["external.copy_pct"] <= 100
    assert got["external.merge_pct"] > 0 and got["external.copy_pct"] > 0
