"""The reader of ``groupby.one_pass_pct``: 100 x the delta of the
program's ``ops/aggregate.py::ONE_PASS_ROWS`` over the delta of
``REDUCED_ROWS``; nothing where the program has no such counters (the
parent of the change that added them) or they stand still; 100 in a
traced Q1 run on the CPU, whose six reductions all take one reverse
scan."""

import importlib
import time
from types import SimpleNamespace

import pytest
import torch

import harness

NAME = "groupby.one_pass_pct"


def ctx_of(**kw):
    base = dict(state={}, calls=0, layer={"rows": 1000}, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def aggregate_module(rt):
    return importlib.import_module(f"{rt.__name__}.ops.aggregate")


@pytest.mark.parametrize("one,total,want", [(3_000, 4_000, 75.0),
                                            (4_000, 4_000, 100.0),
                                            (0, 4_000, 0.0),
                                            (0, 0, None)])
def test_the_share_of_the_counter_deltas(rt, monkeypatch, one, total, want):
    mod = aggregate_module(rt)
    monkeypatch.setattr(mod, "ONE_PASS_ROWS", 10**9)
    monkeypatch.setattr(mod, "REDUCED_ROWS", 2 * 10**9)
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=2)
    reader.start(ctx)
    monkeypatch.setattr(mod, "ONE_PASS_ROWS", 10**9 + one)
    monkeypatch.setattr(mod, "REDUCED_ROWS", 2 * 10**9 + total)
    assert reader.read(ctx) == want


@pytest.mark.parametrize("missing", ["ONE_PASS_ROWS", "REDUCED_ROWS"])
def test_a_program_without_the_counters_reads_nothing(rt, monkeypatch,
                                                      missing):
    mod = aggregate_module(rt)
    monkeypatch.delattr(mod, missing)
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=2)
    reader.start(ctx)
    other = ("REDUCED_ROWS" if missing == "ONE_PASS_ROWS"
             else "ONE_PASS_ROWS")
    monkeypatch.setattr(mod, other, getattr(mod, other) + 5)
    assert reader.read(ctx) is None


def test_the_metric_in_a_traced_q1_cpu_run(rt):
    """Q1 at SF 0.01 on the CPU: its five sums and its count all take one
    reverse scan, so the share reads 100."""
    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, "tpch_q1_sf30")
    cfg = dict(cfg, scale_factor=0.01)
    mix = dict(mix, check_calls=1, trace_calls=2)
    metrics = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert [m["workloads"] for m in metrics] == [["tpch_q1_sf30"]]
    assert [(m["layer"], m["moves"]) for m in metrics] == [
        ("operators", "call_p95_ms")]
    out = harness.run_cell(rt, w, cfg, mix, seed=2**31 + 29, seconds=5.0,
                           trace=True, device=torch.device("cpu"),
                           t0=time.monotonic(), metrics=metrics)
    assert out["correct"]
    assert out["metrics"][NAME]["value"] == 100.0
