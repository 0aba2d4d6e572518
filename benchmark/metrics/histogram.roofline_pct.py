"""histogram.roofline_pct (device_trace): the histogram kernel's share of
its roofline. Per launch, rows x key limbs x 4 bytes read once, over the
card's memory rate, against the kernel's own device time, summed over the
traced window's launches."""

KERNEL = "hist_kernel"  # csrc/histogram.cu


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("histogram.roofline_pct is a device metric: no "
                           "card")
    limbs = ctx.layer.get("key_limbs")
    ops = [op for op in ctx.trace.ops if KERNEL in op.name]
    if limbs is None or not ops:
        return None
    least_s = len(ops) * ctx.layer["rows"] * limbs * 4 / ctx.hbm_bytes_per_s
    return 100.0 * least_s / (sum(op.us for op in ops) / 1e6)
