"""The device operations (kernels, copies, memsets) one call starts, as a
mean over the traced window's calls."""


def read(ctx):
    calls = ctx.summary.calls
    if not calls or ctx.summary.device_ops == 0:
        return None
    return sum(c["device_ops"] for c in calls) / len(calls)
