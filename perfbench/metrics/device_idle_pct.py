"""The share of the traced window in which no kernel runs: 100 less the
union of the kernels' intervals over the window (copies do not count as
work here)."""

import devtrace


def read(ctx):
    w0, w1 = ctx.trace.window
    if w1 <= w0 or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - devtrace.busy_ns(ctx.trace.kernels) / (w1 - w0))
