"""The pipeline's stage spans (``utils.profiling.span``) on the CPU.

Under a ``torch.profiler`` session one ``Pipeline`` call shows each
``df3d.*`` stage span as often as the call runs the stage, nested inside
one ``df3d.call``; the outputs are the same bits with and without the
profiler; with no profiler recording a span is one shared no-op context that
enters no ``record_function``; and ``trace_to`` writes the spans into its
trace.  A tiny seeded net on the frame-0 recording, with rig registration on.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from deepfly3d_torch.models.hourglass import HourglassSpec, init_params
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.pipeline import build_pipeline
from deepfly3d_torch.utils import profiling
from deepfly3d_torch.utils.profiling import span, trace_to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
TINY = dict(num_stacks=1, features=16, depth=2, num_blocks=1, num_classes=19,
            input_shape=(32, 64))
# span -> (times in one call, its parent)
STAGES = {
    "df3d.call": (1, None),
    "df3d.register.copy": (1, "df3d.call"),
    "df3d.register.estimate": (1, "df3d.call"),
    "df3d.preprocess": (1, "df3d.call"),
    "df3d.net": (1, "df3d.call"),
    "df3d.decode": (1, "df3d.call"),
    "df3d.assemble": (2, "df3d.call"),
    "df3d.triangulate": (1, "df3d.call"),
}


@pytest.fixture(scope="module")
def pipe_and_frames():
    spec = HourglassSpec(**TINY)
    variables = init_params(spec, spec.input_shape, torch.Generator().manual_seed(0),
                            device="cpu")
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    with np.load(GOLDEN_T0) as z:
        frames, order = np.ascontiguousarray(z["frames"][None]), list(z["camera_ordering"])
    return build_pipeline(spec, variables, calib, order, device="cpu"), frames


def _spans(prof):
    """(name, start, end) of every df3d.* host span the profiler kept, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.SPAN_PREFIX)
           and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda sp: (sp[1], -sp[2]))


def test_one_call_shows_each_stage_span_nested_in_its_call(pipe_and_frames):
    pipe, frames = pipe_and_frames
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe(frames)
    spans = _spans(prof)
    counts = {name: sum(1 for n, _, _ in spans if n == name) for name in STAGES}
    assert counts == {name: times for name, (times, _) in STAGES.items()}
    stack, parents = [], []
    for name, s, e in spans:                 # the innermost span holding each one
        while stack and stack[-1][2] <= s:
            stack.pop()
        parents.append((name, stack[-1][0] if stack else None))
        assert not stack or e <= stack[-1][2], name
        stack.append((name, s, e))
    assert all(parent == STAGES[name][1] for name, parent in parents)
    assert [n for n, _ in parents] == ["df3d.call", "df3d.register.copy",
                                       "df3d.register.estimate", "df3d.preprocess", "df3d.net",
                                       "df3d.decode", "df3d.assemble", "df3d.triangulate",
                                       "df3d.assemble"]


def test_outputs_are_the_same_bits_with_the_profiler_on(pipe_and_frames):
    pipe, frames = pipe_and_frames
    off = pipe(frames)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = pipe(frames)
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_with_no_profiler_a_span_is_the_shared_no_op(pipe_and_frames, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first, second = span("call"), span("net")
    assert first is second
    with first as got:
        assert got is None
    pipe, frames = pipe_and_frames
    pts3d, p38, conf = pipe(frames)
    assert pts3d.shape == (1, 38, 3) and p38.shape == (7, 1, 38, 2) and conf.shape == (7, 1, 19, 1)


def test_while_a_profiler_records_a_span_is_a_named_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("net"):
            torch.ones(4) + 1
    assert [n for n, _, _ in _spans(prof)] == ["df3d.net"]


def test_trace_to_writes_the_stage_spans(pipe_and_frames, tmp_path):
    pipe, frames = pipe_and_frames
    logdir = tmp_path / "trace"
    with trace_to(str(logdir)):
        pipe(frames)
    files = os.listdir(logdir)
    assert len(files) == 1
    with open(logdir / files[0]) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    assert {n for n in names if n.startswith("df3d.")} == set(STAGES)
