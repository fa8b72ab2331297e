"""The whole call's share of the card's peak: the frozen FLOP count of a call
(forward and preprocess, ``yardstick.call_flops``) times the traced window's
calls, over the window's seconds, over the dense tensor-core peak of the
configuration's arithmetic (TF32's 495 TFLOP/s for float32)."""

import yardstick


def read(ctx):
    if not ctx.trace.calls:
        return None
    rate = yardstick.call_flops(ctx.cfg, ctx.T) * ctx.trace.calls / ctx.window_s
    return 100.0 * rate / yardstick.peak_flops(ctx.cfg["dtype"])
