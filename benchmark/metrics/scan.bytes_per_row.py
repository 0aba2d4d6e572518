"""scan.bytes_per_row (program_counter): the bytes the segmented scans read
and write per call (the delta of ``kernels/scan.py::BYTES`` over the traced
window, over its calls), per input row of the call. A scan of n rows of
S-byte values adds n x (2 S + 1) with head flags, n x 2 S without; where
the program has no such counter it reads nothing."""

import importlib


def _bytes():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.kernels.scan"), "BYTES", None)


def start(ctx):
    ctx.state["scan.bytes_per_row"] = _bytes()


def read(ctx):
    before, now = ctx.state["scan.bytes_per_row"], _bytes()
    if before is None or now == before or not ctx.calls:
        return None
    return (now - before) / ctx.calls / ctx.layer["rows"]
