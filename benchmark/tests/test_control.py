"""``correct`` against its control and the faults each cell can have, on
the CPU at sizes a test run holds (the kernels' plain versions run the
timed path). The controls are also run on the card at each cell's own
size (``seeds.py --control``; PERF.md gives the readings).

Faults planted under the timed path: a step that returns its input
unchanged, half of the rows left out, an answer altered where it is
produced. A cell on one chip has no exchange to leave out.
"""

import importlib
import time

import pytest
import torch

import harness

SEED = 2**31 + 23
SIZES = {  # cell -> (configuration changes, mix changes)
    "cccl_pairs_u64_2e28": ({"elements": [1, 1 << 28]},
                            {"rows": 1 << 18, "check_pool": 2}),
    "tpch_q3_sf30": ({"scale_factor": 0.01}, {}),
    "cccl_keys_u32_2e24": ({"elements": [1, 1 << 28]},
                           {"rows": 1 << 16, "check_pool": 2}),
    "cccl_pairs_u64_2e28_e0201": ({"elements": [1, 1 << 28]},
                                  {"rows": 1 << 12, "check_pool": 2}),
}
SORT_CELLS = [c for c in SIZES if c.startswith("cccl_")]


def run(rt, cell: str, control: str | None = None) -> dict:
    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, cell)
    cfg_changes, mix_changes = SIZES[cell]
    cfg, mix = dict(cfg, **cfg_changes), dict(mix, **mix_changes)
    return harness.run_cell(rt, w, cfg, mix, seed=SEED, seconds=0.3,
                            trace=False, device=torch.device("cpu"),
                            t0=time.monotonic(), metrics=spec["end_to_end"],
                            control=control)


def mismatched(result: dict) -> int:
    return result["checks"]["mismatched_rows"]["value"]


@pytest.mark.parametrize("cell", SIZES)
def test_the_program_is_correct(rt, cell):
    r = run(rt, cell)
    assert r["correct"] and mismatched(r) == 0 and r["calls"] >= 1


@pytest.mark.parametrize("cell", SIZES)
def test_the_control_is_not_correct(rt, cell):
    control = harness.cell_spec(harness.benchmark_spec(), cell)[2]["control"]
    r = run(rt, cell, control)
    assert not r["correct"] and mismatched(r) > 0


def _sort_fault(kind: str):
    """A fault in the LSD loop (``kernels/pipeline.py::sort_limbs``)."""
    pipeline = importlib.import_module(
        "cuda.radixsort_tpu_torch.kernels.pipeline")
    good = pipeline.sort_limbs

    def faulty(limbs, limb_bits, payloads, cfg):
        if kind == "unchanged":
            return [t.clone() for t in limbs], [t.clone() for t in payloads]
        if kind == "half":
            h = limbs[0].numel() // 2
            top, pay = good([t[:h].contiguous() for t in limbs], limb_bits,
                            [t[:h].contiguous() for t in payloads], cfg)
            return ([torch.cat([a.view(torch.int32), t[h:].view(torch.int32)])
                     .view(t.dtype) for a, t in zip(top, limbs)],
                    [torch.cat([a.view(torch.int32), t[h:].view(torch.int32)])
                     .view(t.dtype) for a, t in zip(pay, payloads)])
        out_limbs, out_pay = good(limbs, limb_bits, payloads, cfg)
        flipped = out_limbs[-1].view(torch.int32).clone()
        flipped[len(flipped) // 3] ^= 1
        return out_limbs[:-1] + [flipped.view(out_limbs[-1].dtype)], out_pay

    return pipeline, "sort_limbs", faulty


def _query_fault(kind: str):
    """A fault in the query layer (``pipeline/plan.py``)."""
    plan = importlib.import_module("cuda.radixsort_tpu_torch.pipeline.plan")
    if kind == "unchanged":  # order_by hands its input on unsorted
        table = dict(plan._EXEC)
        table["order_by"] = lambda t, count, st, config: (t, count)
        return plan, "_EXEC", table
    if kind == "half":  # every stage sees half of its valid rows
        good = plan._valid_mask

        def half(t, count):
            return good(t, count) & (torch.arange(
                t.num_rows, dtype=torch.int32) < t.num_rows // 2)

        return plan, "_valid_mask", half
    good = plan.groupby_multi

    def altered(*args, **kwargs):  # each group's revenue one cent high
        keys, vals, count = good(*args, **kwargs)
        return keys, tuple(v + 1 for v in vals), count

    return plan, "groupby_multi", altered


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", SIZES)
def test_a_fault_under_the_timed_path_is_not_correct(rt, monkeypatch, cell,
                                                    kind):
    module, name, faulty = (_sort_fault(kind) if cell in SORT_CELLS
                            else _query_fault(kind))
    monkeypatch.setattr(module, name, faulty)
    r = run(rt, cell)
    assert not r["correct"] and mismatched(r) > 0
