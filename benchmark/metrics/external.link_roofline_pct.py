"""external.link_roofline_pct (device_trace): the out-of-core copies'
share of the host link's rate. The bytes the program copied between host
and card in the traced window (the delta of
``ops/external.py::LINK_BYTES``) over the link's rate in one direction,
against the summed device time of the ``Memcpy HtoD`` and ``Memcpy DtoH``
ops launched under an ``external.h2d`` or ``external.d2h`` range, in
percent. Each op's own time is summed, not their union, so copies in two
directions at once cannot read above 100%. Nothing where no such copy ran
(on the CPU, or in a program without the ranges or the counter)."""

import importlib

# PCIe 5.0 x16, one direction: 32 GT/s x 16 lanes x 128/130 encoding / 8
LINK_BYTES_PER_S = 63.0e9
COPIES = ("Memcpy HtoD", "Memcpy DtoH")
RANGES = ("external.h2d", "external.d2h")


def _bytes():
    return getattr(importlib.import_module(
        "cuda.radixsort_tpu_torch.ops.external"), "LINK_BYTES", None)


def start(ctx):
    ctx.state["external.link_roofline_pct"] = _bytes()


def read(ctx):
    before, now = ctx.state["external.link_roofline_pct"], _bytes()
    ops = [op for op in ctx.trace.ops if op.name.startswith(COPIES)
           and any(r in RANGES for r in op.ranges)]
    if before is None or now == before or not ops:
        return None
    return 100.0 * (now - before) / LINK_BYTES_PER_S \
        / (sum(op.us for op in ops) / 1e6)
