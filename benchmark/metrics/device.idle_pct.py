"""device.idle_pct (device_trace): the share of the traced window in which
no kernel, memcpy or memset of the program ran on the card, in percent."""


def read(ctx):
    if not ctx.on_card:
        raise RuntimeError("device.idle_pct is a device metric: no card")
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)
