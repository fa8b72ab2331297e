"""What launching a call's work costs the host: the summed durations of the
CUDA API calls that launch a kernel (``cudaLaunchKernel``, ``cuLaunchKernel``
and their ``Ex`` forms, every name that holds ``Launch``) inside the
benchmark's ``call`` spans, per call.  Synchronisations and copies, in
which the host waits for the device, are left out.  Measured with the
profiler on, whose callbacks lengthen each API call alike on both sides."""

import bisect
from collections import Counter


def read(ctx):
    calls = sorted((s, e) for n, s, e in ctx.trace.spans if n == "perfbench.call")
    launches = [(n, s, e) for n, s, e in ctx.trace.runtime if "Launch" in n]
    if not calls or not launches:
        return None
    starts = [s for s, _ in calls]
    total, names = 0, Counter()
    for n, s, e in launches:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= calls[i][1]:
            total += e - s
            names[n] += 1
    note = (f"{sum(names.values()) / len(calls):.1f} launch calls a call ({dict(names)}); "
            f"{len(ctx.trace.kernels) / len(calls):.1f} device kernels a call")
    return total / len(calls) * 1e-6, note
