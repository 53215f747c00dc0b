"""The kernels' share of their roofline, in %: the least time the card
needs for the calls' work (the larger of the operations the algorithm
needs for the iterations and line-search candidates each scenario takes,
over the published peak outside the tensor cores, and the bytes of the
inputs read once and results written once, over 3.35 TB/s; see
``benchmark/work/``) over the summed device time of every kernel in the
traced window's calls."""


def read(ctx):
    rows = [(call, bound) for call, _, bound in ctx.calls_with_work()
            if call["kernel_s"] > 0]
    if not rows:
        return None
    return 100.0 * sum(b for _, b in rows) / sum(c["kernel_s"]
                                                 for c, _ in rows)
