"""The residual blocks' share of their roofline: the sum of the bounds of the
window's block launches (``yardstick.blocks`` of the configuration, one
launch per block and forward; a forward takes the mix's ``batch_size``
images, or every image of a call where the mix names none; a bound is
max(ops / peak, bytes / HBM bandwidth), ops the block's own multiply-adds x
2, bytes x and the output once and the weights once) over the device time of
the kernels whose name holds ``bottleneck``."""

import devtrace
import yardstick


def read(ctx):
    launches = [(n, e - s) for n, s, e in ctx.trace.kernels if "bottleneck" in n]
    times = [t for _, t in launches]
    if not times or not ctx.trace.calls:
        return None
    images = ctx.T * ctx.cfg["num_cameras"]
    n = int(ctx.mix.get("batch_size", images))
    forwards = -(-images // n)
    bounds = [yardstick.bound_s(yardstick.block_flops(*b) * n, yardstick.block_bytes(b, n),
                                ctx.cfg["dtype"])
              for b in yardstick.blocks(ctx.cfg["spec"], tuple(ctx.cfg["spec"]["input_shape"]))]
    by_bytes = sum(1 for _, which in bounds if which == "bytes")
    note = (f"{by_bytes} of {len(bounds)} blocks bound by bytes; {len(times)} launches, "
            f"{len(bounds) * forwards * ctx.trace.calls} blocks in {ctx.trace.calls} calls; "
            f"{sorted({devtrace.short_name(n) for n, _ in launches})}")
    total = sum(t for t, _ in bounds) * forwards * ctx.trace.calls
    return 100.0 * total / (sum(times) * 1e-9), note
