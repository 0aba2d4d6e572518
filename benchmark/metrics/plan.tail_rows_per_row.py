"""plan.tail_rows_per_row (program_counter): rows the one-device
``Query.run`` cut from its stages' tables per call (the delta of
``pipeline/plan.py::TAIL_ROWS`` over the traced window, over its calls),
per input row of the call. Each cut drops the rows past a stage's count
before the next stage sorts, gathers or masks them; where the program
keeps every stage's full length it has no such counter and this reads
nothing."""

import importlib


def _tail():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.pipeline.plan"), "TAIL_ROWS", None)


def start(ctx):
    ctx.state["plan.tail_rows_per_row"] = _tail()


def read(ctx):
    before, now = ctx.state["plan.tail_rows_per_row"], _tail()
    if before is None or now == before or not ctx.calls:
        return None
    return (now - before) / ctx.calls / ctx.layer["rows"]
