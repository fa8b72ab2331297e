"""The traced run: spans the benchmark records and the device trace, reduced.

``wrap_stages`` puts the pipeline's stage attributes, and the harness its
calls into the program, in ``torch.profiler.record_function`` ranges.
``reduce`` reads the profiler's raw events once: the device's kernels and
copies inside the window, the host's CUDA API calls, and the benchmark's
host spans, on the profiler's one clock (nanoseconds).
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

PREFIX = "perfbench."
# the host's CUDA API calls in the trace (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME = ("cuda", "cu")
# the pipeline's stage attributes that the traced run wraps where they exist
STAGES = ("_register", "_points", "preprocess", "net", "decode", "_assemble", "_finish", "_conf")


class _Spanned:
    """A callable in a named host span; other attributes pass through."""

    def __init__(self, name: str, fn):
        self._name, self._fn = name, fn

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(self._name):
            return self._fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


def wrap_stages(pipe) -> None:
    """Put each stage attribute of ``pipe`` that exists in a span ``perfbench.<stage>``."""
    for attr in STAGES:
        fn = getattr(pipe, attr, None)
        if callable(fn):
            setattr(pipe, attr, _Spanned(PREFIX + attr.strip("_"), fn))


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
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def reduce(prof) -> SimpleNamespace:
    """-> ``window`` (start, end ns), ``kernels`` and ``copies`` [(name, start, end)]
    inside it, ``runtime``: the host's CUDA runtime and driver calls inside
    it, ``spans`` [(name, start, end)] of the benchmark, ``calls``, and
    ``dropped``: the device timeline's other ranges (the spans' own images on
    the device, nameless ranges), seconds by name."""
    device, spans, runtime = [], [], []
    dropped: Dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name or name.startswith(PREFIX) or _annotation(e):
                dropped[name[:40] or "(no name)"] += (end - start) * 1e-9
            else:
                device.append((name, start, end))
        elif name.startswith(PREFIX):
            spans.append((name, start, end))
        elif name.startswith(RUNTIME):
            runtime.append((name, start, end))
    window = [(s, e) for n, s, e in spans if n == PREFIX + "window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    copies = [ev for ev in inside if ev[0].startswith(("Memcpy", "Memset"))]
    kernels = [ev for ev in inside if not ev[0].startswith(("Memcpy", "Memset"))]
    return SimpleNamespace(window=(w0, w1), kernels=kernels, copies=copies,
                           runtime=[ev for ev in runtime if ev[2] > w0 and ev[1] < w1],
                           spans=[sp for sp in spans if sp[0] != PREFIX + "window"],
                           calls=sum(1 for n, _, _ in spans if n == PREFIX + "call"),
                           dropped=dict(dropped))


def busy_ns(events) -> int:
    return sum(e - s for s, e in _union([(s, e) for _, s, e in events]))


def breakdown(tr: SimpleNamespace) -> Dict[str, list]:
    """The 10 device operations that took most time, and the idle gaps
    between kernels summed by the innermost benchmark span they fall in."""
    by_op: Dict[str, int] = defaultdict(int)
    for n, s, e in tr.kernels + tr.copies:
        by_op[short_name(n)] += e - s
    busy = _union([(s, e) for _, s, e in tr.kernels])
    w0, w1 = tr.window
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    # the benchmark's spans nest: a stack swept along the gaps' midpoints
    spans = sorted(tr.spans, key=lambda sp: (sp[1], -sp[2]))
    by_span: Dict[str, int] = defaultdict(int)
    stack: list = []
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(spans) and spans[i][1] <= mid:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        by_span[stack[-1][0] if stack else "outside the calls"] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v * 1e-9] for n, v in top],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
