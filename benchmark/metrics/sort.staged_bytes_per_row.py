"""sort.staged_bytes_per_row (program_counter): bytes per input row that
the sort API's radix route read and wrote in torch copies of key and
payload columns on their way into or out of the LSD loop (twiddles,
widening, limb split and join, clones): the delta of
``ops/sort.py::STAGED_BYTES`` over the traced window, over its calls, per
input row of a call. 0 where the loop reads the caller's words and writes
the result's (unsigned keys in ascending order, 4- and 8-byte payloads)."""

import importlib


def _bytes():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.ops.sort"), "STAGED_BYTES", None)


def start(ctx):
    ctx.state["sort.staged_bytes_per_row"] = _bytes()


def read(ctx):
    before, now = ctx.state["sort.staged_bytes_per_row"], _bytes()
    if before is None or now is None or not ctx.calls:
        return None
    return (now - before) / ctx.calls / ctx.layer["rows"]
