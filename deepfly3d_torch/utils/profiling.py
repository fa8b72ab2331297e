"""Per-stage wall-clock timing (``StageTimer``) and device traces (``trace_to``).

Counterpart of ``deepfly3d_tpu/utils/profiling.py``: the host clock per
named stage, with derived frames per second.  Work queued on a card is
asynchronous, so a timer given a CUDA ``device`` synchronizes it at the end
of every stage: a stage's time then includes the device work it queued.
``trace_to`` writes a ``torch.profiler`` trace where the JAX package writes
a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional


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
    and CUDA activity where a card is present."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
