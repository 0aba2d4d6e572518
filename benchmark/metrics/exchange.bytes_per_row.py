"""exchange.bytes_per_row (program_counter): bytes rank 0 sent to other
ranks per call (the delta of ``parallel/comm.py::SENT_BYTES``, which every
``all_to_all`` and ``all_gather`` adds to, lane padding included, over the
traced window, over its calls), per input row of rank 0's partition."""

import importlib


def _sent():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.parallel.comm"), "SENT_BYTES", None)


def start(ctx):
    ctx.state["exchange.bytes_per_row"] = _sent()


def read(ctx):
    before, now = ctx.state["exchange.bytes_per_row"], _sent()
    rows = ctx.layer.get("rank_rows")
    if before is None or now == before or not ctx.calls or not rows:
        return None
    return (now - before) / ctx.calls / rows
