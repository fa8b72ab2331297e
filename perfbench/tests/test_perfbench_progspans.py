"""The program's spans in a traced run (``progspans.py``) and the four readers
of them, on a hand-made trace of raw profiler events and on a CPU run.

The hand-made trace holds two calls of the same shape, 100 ms apart, in a
200 ms window: the benchmark's spans, the program's ``df3d.*`` spans, the
CUDA API calls that launch each kernel and copy (by correlation id), the
device's kernels and copies, and the spans' own images on the device.
"""

from types import SimpleNamespace

import pytest
import torch

import devtrace
import harness
import progspans
from conftest import tiny_cell

MS = 1_000_000
READERS = ("registration_ms", "registration_idle_ms", "glue_ms", "tail_ms")

# one call, ms from its start: host spans, then (API call, its start, device op, start, end)
HOST = [("perfbench.call", 0, 90), ("df3d.call", 1, 89), ("df3d.register.copy", 2, 10),
        ("df3d.register.estimate", 10, 30), ("df3d.preprocess", 30, 35), ("df3d.net", 35, 70),
        ("df3d.decode", 70, 75), ("df3d.assemble", 75, 77), ("df3d.triangulate", 77, 85),
        ("df3d.assemble", 85, 87), ("perfbench.to_host", 90, 98)]
WORK = [("cudaMemcpyAsync", 3, "Memcpy HtoD (Pinned -> Device)", 3.5, 8.5),
        ("cudaLaunchKernel", 11, "void at::native::reduce_kernel<512, 1>(int)", 12, 16),
        ("cudaLaunchKernel", 20, "void at::native::elementwise_kernel<128, 2>(int)", 21, 23),
        ("cudaLaunchKernel", 31, "void preprocess_run_kernel<3>(float*)", 32, 36),
        ("cudaLaunchKernel", 36, "cudnn_conv_kernel", 37, 45),
        ("cuLaunchKernel", 37, "void bottleneck_kernel<96, 48, 96>(float*)", 45, 60),
        ("cudaLaunchKernel", 38, "void upsample2x_add_kernel<float>(float*)", 60, 62),
        ("cudaLaunchKernelExC", 39, "cutlass_80_simt_sgemm_128x128", 62, 66),
        ("cudaLaunchKernel", 71, "void decode_finish_kernel(float*)", 71.5, 72.5),
        ("cudaLaunchKernel", 76, "void at::native::elementwise_kernel<128, 4>(int)", 76.5, 77),
        ("cudaLaunchKernel", 78, "void at::native::vectorized_kernel<4>(int)", 78.5, 80.5),
        ("cudaLaunchKernel", 88, "void at::native::fill_kernel(int)", 88.2, 88.4),
        ("cudaMemcpyAsync", 91, "Memcpy DtoH (Device -> Pageable)", 91, 92)]
IMAGES = [("df3d.net", 37, 66), ("df3d.call", 3.5, 88.4), ("perfbench.call", 3.5, 88.4)]


class Ev:
    """A raw profiler event, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, cuda=False, corr=0, annotation=False):
        self._v = (name, round(start * MS), round((end - start) * MS), corr, annotation)
        self._dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return 1


def _events(program=True, images=True):
    evs = [Ev("perfbench.window", 0, 200, annotation=True)]
    for k, t in enumerate((0, 100)):
        evs += [Ev(n, t + s, t + e, annotation=True) for n, s, e in HOST
                if program or n.startswith("perfbench.")]
        for j, (api, at, op, s, e) in enumerate(WORK):
            corr = 100 * k + j + 1
            evs += [Ev(api, t + at, t + at + 0.1, corr=corr),
                    Ev(op, t + s, t + e, cuda=True, corr=corr)]
        evs += [Ev("cudaStreamSynchronize", t + 9, t + 9.5, corr=100 * k + 99)]
        if images:
            evs += [Ev(n, t + s, t + e, cuda=True, annotation=True) for n, s, e in IMAGES
                    if program or n.startswith("perfbench.")]
    return evs


def _ctx(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    cell = harness.load_cell("fly_conv.pinned_T32")
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=32, trace=devtrace.reduce(prof),
                          window_s=0.2)
    progspans.of(ctx)
    return ctx


def test_spans_have_their_parents_and_calls():
    p = _ctx(_events()).trace.program
    assert p.calls == 2 and len(p.spans) == 18
    for name, _, _, parent, call in p.spans:
        assert p.spans[call][0] == "df3d.call"
        assert (parent == -1) if name == "df3d.call" else (p.spans[parent][0] == "df3d.call")


def test_device_work_goes_to_the_innermost_span_that_launched_it():
    p = _ctx(_events()).trace.program
    by_op = {(n, progspans.name_of(p, i)) for n, _, _, i in p.kernels + p.copies}
    assert ("void at::native::reduce_kernel<512, 1>(int)", "df3d.register.estimate") in by_op
    assert ("void bottleneck_kernel<96, 48, 96>(float*)", "df3d.net") in by_op   # driver API
    assert ("cutlass_80_simt_sgemm_128x128", "df3d.net") in by_op
    assert ("void at::native::fill_kernel(int)", "df3d.call") in by_op
    assert ("Memcpy HtoD (Pinned -> Device)", "df3d.register.copy") in by_op
    assert ("Memcpy DtoH (Device -> Pageable)", "") in by_op          # the harness's copy back
    assert len(p.kernels) == 22 and len(p.copies) == 4 and p.unmatched == 0
    assert sorted({n for n, _, _, _ in p.launches}) == ["cuLaunchKernel", "cudaLaunchKernel",
                                                         "cudaLaunchKernelExC",
                                                         "cudaMemcpyAsync"]
    note = progspans.coverage_note(p)
    assert "inside df3d.call: 100.0000%" in note and f"{100 * 0.2 / 42.7:.4f}%" in note
    assert "'Memcpy HtoD in df3d.register.copy': 10.0" in note
    assert ("kernel ms a call by launching span: {'df3d.net': 29.0, 'df3d.register.estimate': "
            "6.0, 'df3d.preprocess': 4.0, 'df3d.triangulate': 2.0, 'df3d.decode': 1.0, "
            "'df3d.assemble': 0.5, 'df3d.call': 0.2}") in note


def test_the_spans_device_images_are_not_work():
    with_images, without = _ctx(_events()), _ctx(_events(images=False))
    assert not any(n.startswith(("df3d.", "perfbench.")) for n, _, _, _ in
                   with_images.trace.program.kernels)
    assert with_images.trace.kernels == without.trace.kernels
    idle = harness.metric_reader("device_idle_pct")
    assert idle(with_images) == idle(without) == pytest.approx(57.3)
    assert "df3d.net" in with_images.trace.dropped


def test_idle_goes_to_the_innermost_program_span_else_the_benchmark_span():
    ctx = _ctx(_events())
    idle = progspans.idle_by_span(ctx.trace.program, ctx.trace)
    want = {"df3d.register.copy": 8, "df3d.register.estimate": 14, "df3d.preprocess": 2,
            "df3d.net": 5, "df3d.decode": 4, "df3d.assemble": 3.5, "df3d.triangulate": 6,
            "df3d.call": 2.8, "perfbench.call": 2, "perfbench.to_host": 8,
            "outside_the_calls": 2}
    assert set(idle) == set(want)
    for name, ms in want.items():
        assert idle[name] == pytest.approx(2 * ms * MS, abs=2), name


@pytest.mark.parametrize("name,value", [("registration_ms", 6.0), ("registration_idle_ms", 22.0),
                                        ("glue_ms", 12.0), ("tail_ms", 3.5)])
def test_reader_values(name, value):
    got, note = harness.metric_reader(name)(_ctx(_events()))
    assert got == pytest.approx(value)
    assert ("idle ms a call by span" if name == "registration_idle_ms" else "launch calls") in note


def test_reader_notes_count_the_launches():
    ctx = _ctx(_events())
    _, reg = harness.metric_reader("registration_ms")(ctx)
    assert ("df3d.register.copy: 1.0 launch calls a call {'cudaMemcpyAsync': 1.0}; "
            "1.0 device operations a call") in reg
    assert "df3d.register.estimate: 2.0 launch calls a call" in reg
    _, glue = harness.metric_reader("glue_ms")(ctx)
    assert glue.startswith("4.0 launch calls a call") and "'cudnn_conv_kernel': 8.0" in glue
    _, tail = harness.metric_reader("tail_ms")(ctx)
    assert "df3d.assemble: 1.0 launch calls a call" in tail


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_program_spans(name):
    ctx = _ctx(_events(program=False))
    assert ctx.trace.program.calls == 0 and ctx.trace.program.spans == []
    assert harness.metric_reader(name)(ctx) is None
    assert harness.metric_reader("device_idle_pct")(ctx) is not None


def test_a_traced_cpu_run_holds_the_programs_spans():
    cpu = torch.device("cpu")
    cell = tiny_cell("df2d256.dev_T16", T=2, chunks=2, features=16, depth=3,
                     stem_channels=[4, 8, 8], input_shape=[64, 128])
    s = harness.setup(cell, 2 ** 31 + 977, cpu)
    harness.warm_up(s)
    w = harness.window(s, 0.3, traced=True)
    tr = devtrace.reduce(w.prof)
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=2, trace=tr, window_s=0.3)
    p = progspans.of(ctx)
    assert tr.program is p and p.calls == tr.calls == len(w.times) >= 1
    names = [sp[0] for sp in p.spans]
    assert names.count("df3d.assemble") == 2 * p.calls
    for stage in ("register.copy", "register.estimate", "preprocess", "net", "decode",
                  "triangulate"):
        assert names.count("df3d." + stage) == p.calls
    assert all(call >= 0 for _, _, _, _, call in p.spans)
    # no device on the CPU: every reader of the program's spans reads nothing
    assert [harness.metric_reader(n)(ctx) for n in READERS] == [None] * 4
