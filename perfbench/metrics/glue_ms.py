"""Device time of the network's glue, per call: the kernels launched inside
the program's ``df3d.net`` spans whose names hold neither ``bottleneck`` nor
``upsample2x_add`` (the port's kernels there): the stem convolution, the
1x1 heads, adds, pools and casts of ``models/fused_inference.py``.  The
note gives the launch calls and device operations a call inside
``df3d.net``, and the glue's five largest kernels."""

from collections import Counter

import devtrace
import progspans

PORT = ("bottleneck", "upsample2x_add")


def read(ctx):
    p = progspans.of(ctx)
    if not p.calls or not p.kernels:
        return None

    def glue(span, name):
        return span == "df3d.net" and not any(k in name for k in PORT)

    top = Counter()
    for n, s, e, i in p.kernels:
        if glue(progspans.name_of(p, i), n):
            top[devtrace.short_name(n)[:60]] += e - s
    largest = {n: round(v / p.calls * 1e-6, 4) for n, v in top.most_common(5)}
    note = (progspans.launch_note(p, lambda span: span == "df3d.net")
            + f"; largest glue kernels, ms a call: {largest}")
    return progspans.device_ms(p, p.kernels, glue), note
