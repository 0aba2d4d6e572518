"""sort.roofline_pct (device_trace): the least memory traffic any sort of
the call needs, every input plane read once and every output plane written
once (2 x row bytes x rows), over the card's memory rate, against the
device's busy time per call, in percent. It reads the same work whatever
implements the sort."""


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("sort.roofline_pct is a device metric: no card")
    row_bytes = ctx.layer.get("row_bytes")
    if row_bytes is None or not ctx.calls:
        return None
    least_s = 2 * row_bytes * ctx.layer["rows"] / ctx.hbm_bytes_per_s
    busy_s = ctx.trace.busy_us() / 1e6 / ctx.calls
    return 100.0 * least_s / busy_s
