"""The mean, over the traced window's calls, of a call's host wall less
the summed device time of the kernels inside it, in ms: what the layer
around the kernels (packing, uploads, launches, downloads, unpacking)
costs a call."""


def read(ctx):
    calls = ctx.summary.calls
    if not calls or not any(c["kernel_s"] > 0 for c in calls):
        return None
    return sum(c["wall_s"] - c["kernel_s"] for c in calls) / len(calls) * 1e3
