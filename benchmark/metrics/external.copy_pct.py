"""external.copy_pct (device_trace): the share of the traced window spent
in the program's copies between host and card: 100 x the summed host time
of its ``external.h2d`` and ``external.d2h`` ranges (``ops/external.py``)
over the window, in percent. That time holds the host's staging copies
through the pinned buffers as well as the transfers, and ``external.d2h``
blocks on its transfer, which waits out the chunk's sort kernels queued
before it: the card's sort time is inside this share, not beside it.
Nothing where no such range opened (a program without them)."""

import harness

RANGES = ("external.h2d", "external.d2h")


def read(ctx):
    return harness.load("metrics", "external.merge_pct").host_pct(ctx, RANGES)
