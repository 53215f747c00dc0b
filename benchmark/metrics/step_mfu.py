"""The whole step's share of the card's peak, in %: the operations the
traced window's calls need (``benchmark/work/``) over the window's
seconds times the published peak of the configuration's precision outside
the tensor cores."""

from benchmark.work import peaks


def read(ctx):
    rows = ctx.calls_with_work()
    if not rows or ctx.summary.window_s <= 0:
        return None
    ops = sum(o for _, o, _ in rows)
    peak = peaks.PEAK_OPS_PER_S[ctx.work.dtype]
    return 100.0 * ops / (ctx.summary.window_s * peak)
