"""The Q1 cell (``tpch_q1_sf30``) on the CPU at SF 0.01, the kernels' plain
versions running the timed path: ``correct`` holds for the program and
fails for the control (float32 means) and for a fault planted under the
timed path (a scan that hands its input on unchanged, half of the rows
left out, one sum altered where it is produced); and ``scan.bytes_per_row``
reads the bytes of the query's scans. The control is also run on the card
at the cell's own size (``seeds.py --control``; PERF.md gives the
readings).
"""

import importlib
import random
import time

import pytest
import torch

import harness

CELL = "tpch_q1_sf30"
SEED = 2**31 + 29


def cell_of(spec):
    w, cfg, mix = harness.cell_spec(spec, CELL)
    return w, dict(cfg, scale_factor=0.01), mix


def run(rt, control: str | None = None) -> dict:
    spec = harness.benchmark_spec()
    w, cfg, mix = cell_of(spec)
    return harness.run_cell(rt, w, cfg, mix, seed=SEED, seconds=0.3,
                            trace=False, device=torch.device("cpu"),
                            t0=time.monotonic(), metrics=spec["end_to_end"],
                            control=control)


def mismatched(result: dict) -> int:
    return result["checks"]["mismatched_rows"]["value"]


def test_the_program_is_correct(rt):
    r = run(rt)
    assert r["correct"] and mismatched(r) == 0 and r["calls"] >= 1


def test_the_control_is_not_correct(rt):
    r = run(rt, harness.cell_spec(harness.benchmark_spec(), CELL)[2]["control"])
    assert not r["correct"] and mismatched(r) > 0


def _fault(kind: str):
    """(module, attribute, faulty replacement) under the timed path."""
    if kind == "unchanged":  # the scan kernel's wrapper returns its input
        kscan = importlib.import_module(
            "cuda.radixsort_tpu_torch.kernels.scan")
        return kscan, "segmented_scan", lambda v, f, op="sum": v.clone()
    plan = importlib.import_module("cuda.radixsort_tpu_torch.pipeline.plan")
    if kind == "half":  # every stage sees half of its valid rows
        good = plan._valid_mask

        def half(t, count):
            return good(t, count) & (torch.arange(
                t.num_rows, dtype=torch.int32) < t.num_rows // 2)

        return plan, "_valid_mask", half
    good = plan.groupby_multi

    def altered(*args, **kwargs):  # each group's sum_charge one unit high
        keys, vals, count = good(*args, **kwargs)
        return keys, vals[:3] + (vals[3] + 1,) + vals[4:], count

    return plan, "groupby_multi", altered


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(rt, monkeypatch, kind):
    module, name, faulty = _fault(kind)
    monkeypatch.setattr(module, name, faulty)
    r = run(rt)
    assert not r["correct"] and mismatched(r) > 0


def test_scan_bytes_per_row_in_a_traced_cpu_run(rt):
    """Each Q1 call scans the m lines its filter keeps: five int64 sums
    with head flags (17 B a line each) and the count's int32 running max
    without flags (8 B a line), 93 m bytes, over the table's rows."""
    spec = harness.benchmark_spec()
    w, cfg, mix = cell_of(spec)
    mix = dict(mix, check_calls=1, trace_calls=3)
    metrics = [m for m in spec["per_layer"]
               if m["name"] == "scan.bytes_per_row"]
    assert [m["workloads"] for m in metrics] == [[CELL]]
    out = harness.run_cell(rt, w, cfg, mix, seed=SEED, seconds=5.0,
                           trace=True, device=torch.device("cpu"), t0=0.0,
                           metrics=metrics)
    assert out["correct"]
    calls = out["attempted"]
    assert calls == 3
    kind = harness.load("traffic", "tpch_q1")
    lineitem = kind.make_lineitem(
        cfg, torch.Generator().manual_seed(SEED % 2**64), torch.device("cpu"))
    deltas = list(range(mix["delta_first"], mix["delta_last"] + 1))
    random.Random(SEED).shuffle(deltas)
    ship = lineitem["l_shipdate"]
    kept = [int((ship <= kind.day(kind.REPORT_END) - d).sum())
            for d in deltas[:calls]]
    want = 93 * sum(kept) / calls / ship.numel()
    assert out["metrics"]["scan.bytes_per_row"]["value"] == pytest.approx(want)
