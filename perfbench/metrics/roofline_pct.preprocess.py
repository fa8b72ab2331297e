"""The preprocess's share of its roofline: per call max(ops / peak, bytes /
HBM bandwidth), ops the resize taps (``yardstick.preprocess_flops``), bytes
the uint8 frames read once and the float32 network input written once,
times the traced calls, over the device time of the kernels whose name
holds ``preprocess``."""

import devtrace
import yardstick


def read(ctx):
    launches = [(n, e - s) for n, s, e in ctx.trace.kernels if "preprocess" in n]
    times = [t for _, t in launches]
    if not times or not ctx.trace.calls:
        return None
    n = ctx.T * ctx.cfg["num_cameras"]
    hw, shape = tuple(ctx.cfg["image_hw"]), tuple(ctx.cfg["spec"]["input_shape"])
    bound, which = yardstick.bound_s(yardstick.preprocess_flops(n, hw, shape),
                                     yardstick.preprocess_bytes(n, hw, shape), ctx.cfg["dtype"])
    note = (f"bound by {which}; {len(times)} launches in {ctx.trace.calls} calls; "
            f"{sorted({devtrace.short_name(n) for n, _ in launches})}")
    return 100.0 * bound * ctx.trace.calls / (sum(times) * 1e-9), note
