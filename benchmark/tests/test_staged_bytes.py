"""The reader of ``sort.staged_bytes_per_row``: the delta of the program's
``ops/sort.py::STAGED_BYTES`` over the window, per call and input row; 0
where the counter stands still; nothing where the program has no such
counter (the parent of the change that added it)."""

import importlib
from types import SimpleNamespace

import pytest

import harness

NAME = "sort.staged_bytes_per_row"


def ctx_of(**kw):
    base = dict(state={}, calls=0, layer={"rows": 1000}, trace=None)
    base.update(kw)
    return SimpleNamespace(**base)


def sort_module(rt):
    return importlib.import_module(f"{rt.__name__}.ops.sort")


@pytest.mark.parametrize("added,calls,want", [(64_000, 4, 16.0),
                                              (0, 4, 0.0),
                                              (64_000, 0, None)])
def test_the_counter_delta_per_call_and_row(rt, monkeypatch, added, calls,
                                            want):
    mod = sort_module(rt)
    monkeypatch.setattr(mod, "STAGED_BYTES", 10**9)
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=calls)
    reader.start(ctx)
    monkeypatch.setattr(mod, "STAGED_BYTES", 10**9 + added)
    assert reader.read(ctx) == want


def test_a_program_without_the_counter_reads_nothing(rt, monkeypatch):
    monkeypatch.delattr(sort_module(rt), "STAGED_BYTES")
    reader = harness.load("metrics", NAME)
    ctx = ctx_of(calls=2)
    reader.start(ctx)
    assert reader.read(ctx) is None


@pytest.mark.parametrize("workload,staged", [
    ("cccl_pairs_u64_2e28", 0.0),  # unsigned u64 keys, u32 payload
    ("tpch_q3_sf30", None),        # int32 columns: twiddled, read > 0
])
def test_the_metric_in_a_traced_cpu_run(rt, workload, staged):
    """The harness's traced run on the CPU at tiny sizes: the pairs cell
    stages nothing; a query twiddles its signed columns."""
    import torch

    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, workload)
    if workload.startswith("cccl"):
        cfg = dict(cfg, elements=[1, 1 << 28])
        mix = dict(mix, rows=1 << 12, check_pool=2, trace_calls=3)
    else:
        cfg = dict(cfg, scale_factor=0.01)
        mix = dict(mix, check_calls=1, trace_calls=2)
    metrics = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert workload in metrics[0]["workloads"]
    out = harness.run_cell(rt, w, cfg, mix, seed=7, seconds=0.5, trace=True,
                           device=torch.device("cpu"), t0=0.0,
                           metrics=metrics)
    assert out["correct"]
    got = out["metrics"][NAME]["value"]
    if staged is None:
        assert got > 0
    else:
        assert got == staged
