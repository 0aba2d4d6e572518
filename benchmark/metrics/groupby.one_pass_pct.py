"""groupby.one_pass_pct (program_counter): the share of the group-by's
per-group reductions (its sums, mins, maxes and counts) that one reverse
pass of the scan kernel made, with no flips of values or flags around a
forward scan: 100 x the delta of ``ops/aggregate.py::ONE_PASS_ROWS`` over
the delta of ``REDUCED_ROWS`` in the traced window (each adds a
reduction's rows). Where the program has no such counters, or the
group-by reduced no row in the window, it reads nothing."""

import importlib

NAME = "groupby.one_pass_pct"


def _counts():
    mod = importlib.import_module("cuda.radixsort_tpu_torch.ops.aggregate")
    one = getattr(mod, "ONE_PASS_ROWS", None)
    total = getattr(mod, "REDUCED_ROWS", None)
    return None if one is None or total is None else (one, total)


def start(ctx):
    ctx.state[NAME] = _counts()


def read(ctx):
    before, now = ctx.state[NAME], _counts()
    if before is None or now is None or now[1] == before[1]:
        return None
    return 100.0 * (now[0] - before[0]) / (now[1] - before[1])
