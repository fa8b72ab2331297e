"""Per-stage wall-clock timing (``StageTimer``), the program's stage spans
(``span``) and device traces (``trace_to``).

Counterpart of ``deepfly3d_tpu/utils/profiling.py``: the host clock per
named stage, with derived frames per second.  Work queued on a card is
asynchronous, so a timer given a CUDA ``device`` synchronizes it at the end
of every stage: a stage's time then includes the device work it queued.
``trace_to`` writes a ``torch.profiler`` trace where the JAX package writes
a ``jax.profiler`` one.

``span`` names a stage of the pipeline (``df3d.<name>``) in whatever
``torch.profiler`` session is recording, ``trace_to``'s or any other: the
span's host interval lands in the session's trace beside the device's
kernels and copies, on the profiler's one clock, and the launches inside it
carry their correlation ids.  With no session recording it costs one read
of the profiler's flag.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch

SPAN_PREFIX = "df3d."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The stage ``df3d.<name>`` as a ``torch.profiler.record_function`` range
    while a profiler records; otherwise one shared no-op context (no range,
    no allocation, no synchronisation, no launch).  The profiler keeps the
    span's name, start and end; its parent and its call are the spans around
    it on its thread."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


class StageTimer:
    """Accumulates wall-clock per named stage; reports a metrics dict."""

    def __init__(self, device=None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.device = device

    def _sync(self):
        if self.device is not None:
            import torch

            dev = torch.device(self.device)
            if dev.type == "cuda" and torch.cuda.is_available():
                torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def metrics(self, frames: Optional[int] = None) -> dict:
        out = {
            name: {"seconds": round(self.totals[name], 4), "calls": self.counts[name]}
            for name in self.totals
        }
        if frames:
            total = sum(self.totals.values())
            out["_summary"] = {
                "total_seconds": round(total, 4),
                "frames": frames,
                "frames_per_sec": round(frames / total, 2) if total else None,
            }
        return out

    def report(self, frames: Optional[int] = None) -> str:
        return json.dumps(self.metrics(frames), indent=2)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``logdir`` as a Chrome trace (``trace_<pid>_<ns>.json``): CPU activity,
    and CUDA activity where a card is present.  The pipeline's ``df3d.*``
    stage spans (``span``) are in it, each above the kernels it launched."""
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
