"""stage.roofline_pct (device_trace): the stage kernel's share of its
roofline. Per launch, rows x planes x 4 bytes read once and written once,
over the card's memory rate, against the kernel's own device time, summed
over the traced window's launches."""

KERNEL = "stage_onesweep"  # csrc/stage.cu


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("stage.roofline_pct is a device metric: no card")
    planes = ctx.layer.get("planes")
    ops = [op for op in ctx.trace.ops if KERNEL in op.name]
    if planes is None or not ops:
        return None
    least_s = len(ops) * 2 * ctx.layer["rows"] * planes * 4 \
        / ctx.hbm_bytes_per_s
    return 100.0 * least_s / (sum(op.us for op in ops) / 1e6)
