"""external.merge_pct (device_trace): the share of the traced window the
host spent merging sorted runs: 100 x the summed host time of the
program's ``external.merge`` ranges (``ops/external.py``) over the window
(the calls' own time), in percent. The card has no work of the call
then. Nothing where no such range opened (a program without them)."""

RANGES = ("external.merge",)


def host_pct(ctx, names) -> float | None:
    """100 x the summed time of the host ranges named ``names`` over the
    window; None where none opened."""
    spans = [h for h in ctx.trace.ranges if h.name in names]
    if not spans or not ctx.trace.window_us:
        return None
    return 100.0 * sum(h.end - h.start for h in spans) / ctx.trace.window_us


def read(ctx):
    return host_pct(ctx, RANGES)
