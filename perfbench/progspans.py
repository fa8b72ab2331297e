"""The program's own spans in a traced run, and the device work each launched.

``deepfly3d_torch`` names its stages in any recording ``torch.profiler``
session (``df3d.call``, ``df3d.register.copy``, ``df3d.net``, ...:
``deepfly3d_torch.utils.profiling.span``).  ``collect`` reads them from the
reduced trace (``devtrace.reduce``): each span with its parent and its call,
and every kernel and copy of the window put down to the innermost program
span whose host interval holds its launch, the CUDA API call (runtime or
driver: ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)
that carries the same correlation id.  A program without the spans (an
older tree) gives empty lists, and every reader of them nothing.
``idle_by_span`` puts the window's device idle down to the same spans.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from types import SimpleNamespace
from typing import Dict, List, Tuple

import devtrace

CALL = devtrace.PROGRAM + "call"


def _parents(spans: List[tuple]) -> List[Tuple[int, int]]:
    """(parent, call) index of each (name, start, end, thread) span, -1 for none:
    the innermost span holding it on its thread, the ``df3d.call`` holding it
    (a call is its own)."""
    out = [(-1, -1)] * len(spans)
    by_thread: Dict[int, list] = defaultdict(list)
    for i, sp in enumerate(spans):
        by_thread[sp[3]].append(i)
    for idx in by_thread.values():
        stack: list = []
        for i in sorted(idx, key=lambda j: (spans[j][1], -spans[j][2])):
            while stack and spans[stack[-1]][2] <= spans[i][1]:
                stack.pop()
            parent = stack[-1] if stack else -1
            call = i if spans[i][0] == CALL else (out[parent][1] if parent >= 0 else -1)
            out[i] = (parent, call)
            stack.append(i)
    return out


def _segments(spans) -> List[Tuple[int, int, int]]:
    """Disjoint (start, end, i), sorted: each stretch of time inside one of the
    nested (name, start, end, ...) ``spans``, labelled by the innermost span
    that holds it (its index)."""
    out: List[Tuple[int, int, int]] = []
    stack: list = []
    cursor = 0

    def upto(t):
        nonlocal cursor
        if stack and t > cursor:
            out.append((cursor, t, stack[-1]))
        cursor = max(cursor, t)

    for i in sorted(range(len(spans)), key=lambda j: (spans[j][1], -spans[j][2])):
        start = spans[i][1]
        while stack and spans[stack[-1]][2] <= start:
            upto(spans[stack[-1]][2])
            stack.pop()
        upto(start)
        stack.append(i)
    while stack:
        upto(spans[stack[-1]][2])
        stack.pop()
    return out


def _innermost(segs, t: int) -> int:
    """The index of the innermost span at time ``t``, -1 outside them all."""
    k = bisect.bisect_right(segs, (t, float("inf"), 0)) - 1
    return segs[k][2] if k >= 0 and segs[k][0] <= t < segs[k][1] else -1


def collect(trace) -> SimpleNamespace:
    """The program's spans and the window's device work, from ``trace``
    (``devtrace.reduce``'s result).  -> ``spans`` [(name, start, end,
    parent, call)] (indices into ``spans``, -1 for none), ``calls``
    (``df3d.call`` spans), ``kernels`` and ``copies`` [(name, start, end,
    span)], ``span`` the index of the innermost program span that held the
    launch (-1: launched outside every program span, or its API call is not
    in the trace), ``launches`` [(api name, start, end, span)] the API calls
    inside the window that put work on the device, and ``unmatched``, the
    device operations whose API call the trace lacks."""
    w0, w1 = trace.window
    raw = sorted(trace.program_spans, key=lambda sp: (sp[1], -sp[2]))
    spans = [(n, s, e, *pc) for (n, s, e, _), pc in zip(raw, _parents(raw))]
    segs = _segments(spans)
    api = trace.launch_api
    launches = sorted((n, s, e, _innermost(segs, s)) for n, s, e in api.values()
                      if w0 <= s < w1)
    kernels, copies, unmatched = [], [], 0
    for n, s, e, corr in trace.work:
        call = api.get(corr)
        unmatched += call is None
        op = (n, s, e, _innermost(segs, call[1]) if call is not None else -1)
        (copies if n.startswith(devtrace.COPY) else kernels).append(op)
    return SimpleNamespace(spans=spans, calls=sum(1 for sp in spans if sp[0] == CALL),
                           kernels=kernels, copies=copies, launches=launches,
                           unmatched=unmatched)


def of(ctx) -> SimpleNamespace:
    """The program's spans of the traced run that ``ctx.trace`` reduces
    (``collect``'s result, read once and kept on the trace for every reader)."""
    got = getattr(ctx.trace, "program", None)
    if got is None:
        ctx.trace.program = got = collect(ctx.trace)
    return got


def name_of(p, i: int) -> str:
    return p.spans[i][0] if i >= 0 else ""


def device_ms(p, ops, keep) -> float:
    """Device time, ms a call, of the ``ops`` whose launching span's name
    passes ``keep(span name, op name)``."""
    return sum(e - s for n, s, e, i in ops if keep(name_of(p, i), n)) / p.calls * 1e-6


def launch_note(p, keep) -> str:
    """The API calls a call that put work on the device inside the spans that
    pass ``keep(span name)``, and the device operations a call they launched."""
    apis = Counter(n for n, _, _, i in p.launches if keep(name_of(p, i)))
    by_api = {n: round(c / p.calls, 2) for n, c in sorted(apis.items())}
    ops = sum(1 for _, _, _, i in p.kernels + p.copies if keep(name_of(p, i)))
    return (f"{sum(apis.values()) / p.calls:.1f} launch calls a call {by_api}; "
            f"{ops / p.calls:.1f} device operations a call")


def coverage_note(p) -> str:
    """How much of the window's device work the program's spans account for:
    the kernel time launched inside a ``df3d.call``, the part of it launched
    in a call but outside every stage span, the kernel time by launching
    span, and where the copies were launched (the harness's copy back is
    outside the program)."""
    total = sum(e - s for _, s, e, _ in p.kernels) or 1
    in_call = sum(e - s for _, s, e, i in p.kernels if i >= 0 and p.spans[i][4] >= 0)
    bare = sum(e - s for _, s, e, i in p.kernels if name_of(p, i) == CALL)
    copies: Dict[str, float] = defaultdict(float)
    for n, s, e, i in p.copies:
        copies[f"{n.split(' (')[0]} in {name_of(p, i) or 'no program span'}"] += (e - s) * 1e-6
    copies_ms = {k: round(v, 3) for k, v in sorted(copies.items())}
    by_span: Dict[str, int] = defaultdict(int)
    for _, s, e, i in p.kernels:
        by_span[name_of(p, i) or "no program span"] += e - s
    kernel_ms = {k: round(v / p.calls * 1e-6, 4) for k, v in
                 sorted(by_span.items(), key=lambda kv: -kv[1])}
    return (f"kernel time launched inside {CALL}: {100.0 * in_call / total:.4f}%, inside it "
            f"outside every stage span: {100.0 * bare / total:.4f}%; kernel ms a call by "
            f"launching span: {kernel_ms}; copies, ms in the window by launching span: "
            f"{copies_ms}; device operations without their API call in the trace: "
            f"{p.unmatched}")


def idle_by_span(p, trace) -> Dict[str, int]:
    """The window's device idle (``devtrace.idle_gaps``), ns by the innermost
    program span the host was in; where no program span holds it, by the
    innermost span of the benchmark's (``perfbench.call``,
    ``perfbench.to_host``), else ``outside_the_calls``."""
    gaps = devtrace.idle_gaps(trace)
    out: Dict[str, int] = defaultdict(int)
    for spans in (p.spans, trace.spans):
        rest = []
        for seg, (gs, ge) in _cut(gaps, _segments(spans)):
            if seg is None:
                rest.append((gs, ge))
            else:
                out[spans[seg][0]] += ge - gs
        gaps = rest
    for gs, ge in gaps:
        out[devtrace.OUTSIDE] += ge - gs
    return dict(out)


def _cut(gaps, segs):
    """Each piece of the sorted, disjoint ``gaps`` with the segment (index
    into the spans) that holds it, None where none does."""
    k = 0
    for gs, ge in gaps:
        t = gs
        while k < len(segs) and segs[k][1] <= t:
            k += 1
        j = k
        while t < ge:
            if j < len(segs) and segs[j][0] <= t:
                end = min(ge, segs[j][1])
                yield segs[j][2], (t, end)
                t = end
                j += 1
            else:
                end = min(ge, segs[j][0]) if j < len(segs) else ge
                yield None, (t, end)
                t = end
