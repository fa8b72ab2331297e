"""The traced run: the profiler's raw events, reduced once.

``reduce`` reads them in one pass, on the profiler's one clock
(nanoseconds): the device's kernels and copies inside the benchmark's
window, with the correlation ids that tie each to its launch; the host's
CUDA API calls; the spans that the harness opens itself
(``perfbench.window``, ``.call``, ``.to_host``); and the program's own
``df3d.*`` spans with their threads, which ``progspans`` reads.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

PREFIX = "perfbench."
PROGRAM = "df3d."                              # deepfly3d_torch.utils.profiling.span
# the host's CUDA API calls in the trace (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME = ("cuda", "cu")
WORK_API = ("Launch", "Memcpy", "Memset")      # API calls that put work on the device
COPY = ("Memcpy", "Memset")
OUTSIDE = "outside_the_calls"


def _annotation(e) -> bool:
    """Whether a raw event is a span's image (not every PyTorch can say)."""
    probe = getattr(e, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and argument list
    (a copy's name as it is)."""
    if name.startswith(COPY):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def reduce(prof) -> SimpleNamespace:
    """-> ``window`` (start, end ns); ``work`` [(name, start, end, correlation
    id)], the device's kernels and copies clipped to it, and the same split as
    ``kernels`` and ``copies`` [(name, start, end)]; ``runtime``: the host's
    CUDA runtime and driver calls inside it; ``launch_api`` {correlation id:
    (name, start, end)}: those that put work on the device; ``spans`` [(name,
    start, end)] of the benchmark and ``calls``, its ``perfbench.call``
    spans; ``program_spans`` [(name, start, end, thread)]: the program's spans
    that start inside the window; and ``dropped``: the device timeline's
    other ranges (the spans' own images on the device, nameless ranges),
    seconds by name."""
    device, spans, program, runtime, api = [], [], [], [], {}
    dropped: Dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name or name.startswith((PREFIX, PROGRAM)) or _annotation(e):
                dropped[name[:40] or "(no name)"] += (end - start) * 1e-9
            else:
                device.append((name, start, end, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name, start, end))
        elif name.startswith(PROGRAM):
            program.append((name, start, end, e.start_thread_id()))
        elif name.startswith(RUNTIME):
            runtime.append((name, start, end))
            if any(k in name for k in WORK_API):
                api[e.correlation_id()] = (name, start, end)
    window = [(s, e) for n, s, e in spans if n == PREFIX + "window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0]
    work = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in device if e > w0 and s < w1]
    return SimpleNamespace(window=(w0, w1), work=work,
                           kernels=[(n, s, e) for n, s, e, _ in work if not n.startswith(COPY)],
                           copies=[(n, s, e) for n, s, e, _ in work if n.startswith(COPY)],
                           runtime=[ev for ev in runtime if ev[2] > w0 and ev[1] < w1],
                           launch_api=api,
                           spans=[sp for sp in spans if sp[0] != PREFIX + "window"],
                           calls=sum(1 for n, _, _ in spans if n == PREFIX + "call"),
                           program_spans=[sp for sp in program if w0 <= sp[1] < w1],
                           dropped=dict(dropped))


def busy_ns(events) -> int:
    return sum(e - s for s, e in _union([(s, e) for _, s, e in events]))


def idle_gaps(tr: SimpleNamespace) -> List[Tuple[int, int]]:
    """The window's stretches in which no kernel runs (a copy is not work,
    as ``device_idle_pct`` counts it), sorted."""
    w0, w1 = tr.window
    edges = [w0] + [t for iv in _union([(s, e) for _, s, e in tr.kernels]) for t in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def breakdown(tr: SimpleNamespace, idle_ns: Dict[str, int]) -> Dict[str, list]:
    """The 10 device operations that took most time, and the 10 largest
    entries of ``idle_ns``: the window's idle, ns by the span that holds it
    (``progspans.idle_by_span``)."""
    by_op: Dict[str, int] = defaultdict(int)
    for n, s, e in tr.kernels + tr.copies:
        by_op[short_name(n)] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_ns.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v * 1e-9] for n, v in top],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
