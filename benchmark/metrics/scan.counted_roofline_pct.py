"""scan.counted_roofline_pct (device_trace): the scan kernel's share of its
roofline from the bytes the program counts. ``kernels/scan.py::BYTES``
adds ``scan_bytes`` (each value read once and written once, each flag byte
read once) at every scan; its delta over the traced window, over the card's
memory rate, against the summed device time of ``scan_single_pass`` (every
value type and operator) in the window, in percent. Where the program has
no such counter it reads nothing."""

import importlib

KERNEL = "scan_single_pass"  # csrc/scan.cu


def _bytes():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.kernels.scan"), "BYTES", None)


def start(ctx):
    ctx.state["scan.counted_roofline_pct"] = _bytes()


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("scan.counted_roofline_pct is a device metric: "
                           "no card")
    before, now = ctx.state["scan.counted_roofline_pct"], _bytes()
    ops = [op for op in ctx.trace.ops if KERNEL in op.name]
    if before is None or now == before or not ops:
        return None
    least_s = (now - before) / ctx.hbm_bytes_per_s
    return 100.0 * least_s / (sum(op.us for op in ops) / 1e6)
