"""The share of the traced window in which no kernel, copy or memset runs
on the device, in %."""


def read(ctx):
    s = ctx.summary
    if s.device_ops == 0 or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
