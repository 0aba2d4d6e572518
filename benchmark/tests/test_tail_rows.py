"""The reader of ``plan.tail_rows_per_row``: the delta of the program's
``pipeline/plan.py::TAIL_ROWS`` over the window, per call and input row;
nothing where the program has no such counter (the parent of the change
that added it) or the counter stands still."""

import importlib
from types import SimpleNamespace

import pytest

import harness

NAME = "plan.tail_rows_per_row"


def ctx_of(**kw):
    base = dict(state={}, calls=0, layer={"rows": 1000}, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def plan_module(rt):
    return importlib.import_module(f"{rt.__name__}.pipeline.plan")


@pytest.mark.parametrize("added,calls,want", [(6_000, 4, 1.5),
                                              (0, 4, None),
                                              (6_000, 0, None)])
def test_the_counter_delta_per_call_and_row(rt, monkeypatch, added, calls,
                                            want):
    mod = plan_module(rt)
    monkeypatch.setattr(mod, "TAIL_ROWS", 10**9)
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=calls)
    reader.start(ctx)
    monkeypatch.setattr(mod, "TAIL_ROWS", 10**9 + added)
    assert reader.read(ctx) == want


def test_a_program_without_the_counter_reads_nothing(rt, monkeypatch):
    monkeypatch.delattr(plan_module(rt), "TAIL_ROWS")
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=2)
    reader.start(ctx)
    assert reader.read(ctx) is None


def test_the_metric_in_a_traced_cpu_run(rt):
    """The harness's traced Q3 on the CPU at SF 0.01: about one row cut per
    input row, the LSD loop sorting about 2.2 rows per input row, and the
    query's syncs (the parent's 16 and seven count reads: one after each of
    the six stages that make a new count, one of the join's build_count)."""
    import torch

    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, "tpch_q3_sf30")
    cfg = dict(cfg, scale_factor=0.01)
    mix = dict(mix, check_calls=1, trace_calls=2)
    names = (NAME, "lsd.sorted_rows_per_row", "device.syncs")
    metrics = [m for m in spec["per_layer"] if m["name"] in names]
    assert [m["workloads"] for m in metrics if m["name"] == NAME] == [
        ["tpch_q3_sf30"]]
    out = harness.run_cell(rt, w, cfg, mix, seed=7, seconds=0.5, trace=True,
                           device=torch.device("cpu"), t0=0.0,
                           metrics=metrics)
    assert out["correct"]
    got = {k: out["metrics"][k]["value"] for k in names}
    assert 0.9 < got[NAME] < 1.0
    assert got["lsd.sorted_rows_per_row"] <= 2.4
    assert got["device.syncs"] == 23.0
