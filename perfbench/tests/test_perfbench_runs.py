"""Whole runs on the CPU at a test's size: the result line, the traced path,
and ``correct`` coming out false when the timed path is broken underneath.

The harness's look for a card is skipped (``run.run_cell`` is called with
the CPU), everything else of a run is driven: set-up, warm-up, the window,
the reference and the comparison.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import compare
import devtrace
import harness
import progspans
import run
from reference import pipeline as ref
from conftest import tiny_cell

SEED = 2 ** 31 + 977


def _cell():
    return tiny_cell("df2d256.dev_T16", T=2, chunks=2, features=16, depth=3,
                     stem_channels=[4, 8, 8], input_shape=[64, 128])


def _run(break_program=None, traced=False, seconds=0.3):
    return run.run_cell(_cell(), SEED, seconds, traced, torch.device("cpu"),
                        break_program=break_program)


def test_result_line_has_the_contracts_shape(call_clock):
    result, lines = _run(seconds=1.0)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 4
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"frames_per_s", "call_ms_p95", "peak_mem_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(result["checks"]) == ["conf_err", "cell_gap", "p3d_err", "p3d_resid"]
    assert {n: set(c) for n, c in result["checks"].items()} == \
        {n: {"value", "limit"} for n in compare.NAMES}
    assert lines[-4:] == [f"check {n}: {c['value']!r} limit {c['limit']!r}"
                          for n, c in result["checks"].items()]
    json.loads(json.dumps(result))


def test_traced_run_leaves_out_what_it_cannot_read(call_clock):
    result, _ = _run(traced=True)
    assert result["correct"] is True
    # no device in a CPU trace, and no CUDA API calls: only the FLOP count finds something
    assert set(result["metrics"]) == {"mfu_pct"}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


class _Stale:
    """Hands back the previous call's outputs: a call that returns its state unchanged."""

    def __init__(self, pipe):
        self.pipe, self.last = pipe, None

    def __call__(self, frames):
        out, self.last = self.last, self.pipe(frames)
        return self.last if out is None else out


def _half(pipe):
    def call(frames):
        T = frames.shape[0]
        p3d, p38, conf = pipe(frames[: T // 2])
        return (torch.cat([p3d] * 2)[:T], torch.cat([p38] * 2, 1)[:, :T],
                torch.cat([conf] * 2, 1)[:, :T])
    return call


def _moved_2d(pipe):
    def call(frames):
        p3d, p38, conf = pipe(frames)
        p38 = p38.clone()
        p38[0, 0, 0, 0] += 1.0 / 64                          # one point one cell down
        return p3d, p38, conf
    return call


def _moved_3d(pipe):
    def call(frames):
        p3d, p38, conf = pipe(frames)
        return p3d * 1.01, p38, conf
    return call


def _zeroed_3d(pipe):
    def call(frames):
        p3d, p38, conf = pipe(frames)
        return torch.zeros_like(p3d), p38, conf
    return call


@pytest.mark.parametrize("fault", [_Stale, _half, _moved_2d, _moved_3d, _zeroed_3d],
                         ids=["state_unchanged", "half_batch", "answer_altered_2d",
                              "answer_altered_3d", "answer_zeroed_3d"])
def test_a_broken_timed_path_is_not_correct(fault, call_clock):
    result, _ = _run(break_program=fault)
    assert result["correct"] is False and result["failed"] > 0


def test_points_that_p3d_err_leaves_out_are_held_by_p3d_resid():
    """A seeded net's views disagree: some points' equations leave their null
    vector undetermined, and ``p3d_err`` does not judge them.  Zeroed there,
    they pass ``p3d_err`` and fail ``p3d_resid``."""
    cell, cpu = _cell(), torch.device("cpu")
    s = harness.setup(cell, SEED, cpu)
    outs = [tuple(t.numpy() for t in s.prog(chunk)) for chunk in s.pool]
    results, rig = cell.entry.reference(cell, s.pool, s.made, cpu, harness.ROOT)
    hw = tuple(cell.cfg["image_hw"])
    p3d, p38, conf = outs[0]
    r = results[0]
    canon = p38 - ref.observed(p38)[..., None] * ref.offsets(r.dy, r.dx, hw)[:, None, None]
    _, separation = ref.triangulate(canon, rig, hw)
    left_out = np.isfinite(separation) & (separation < compare.SEPARATION)
    assert left_out.any()
    sound = compare.judge_call((p3d, p38, conf), r, rig, hw)
    zeroed = p3d.copy()
    zeroed[left_out] = 0.0
    broken = compare.judge_call((zeroed, p38, conf), r, rig, hw)
    assert sound["p3d_resid"] <= cell.limits["p3d_resid"] < broken["p3d_resid"]
    assert broken["p3d_err"] == sound["p3d_err"] <= cell.limits["p3d_err"]
    assert 0 < sound["determined"] < sound["seen"]


def test_readers_on_a_hand_made_trace():
    """Two calls in a 100 ms window; the first holds the program's
    ``df3d.call`` with a registration estimate in it, the second a bare
    ``df3d.call``; the device idles 20-60 and 70-100 ms."""
    ms = 1_000_000
    kernels = [("void bottleneck_kernel(float*)", 0, 10 * ms),
               ("void bottleneck_kernel(float*)", 5 * ms, 20 * ms),
               ("preprocess_run_kernel<3>", 60 * ms, 70 * ms)]
    copies = [("Memcpy HtoD (Pinned -> Device)", 30 * ms, 40 * ms),
              ("Memcpy DtoH (Device -> Pageable)", 80 * ms, 81 * ms)]
    tr = SimpleNamespace(
        window=(0, 100 * ms), calls=2, kernels=kernels, copies=copies,
        work=[(n, s, e, 0) for n, s, e in kernels + copies], launch_api={},
        spans=[("perfbench.call", 0, 45 * ms), ("perfbench.call", 50 * ms, 75 * ms),
               ("perfbench.to_host", 75 * ms, 90 * ms)],
        program_spans=[("df3d.call", 1 * ms, 44 * ms, 1),
                       ("df3d.register.estimate", 25 * ms, 42 * ms, 1),
                       ("df3d.call", 51 * ms, 74 * ms, 1)],
        runtime=[("cudaLaunchKernel", 1 * ms, 2 * ms), ("cuLaunchKernelEx", 3 * ms, 6 * ms),
                 ("cudaStreamSynchronize", 30 * ms, 44 * ms), ("cudaLaunchKernel", 51 * ms,
                                                               53 * ms),
                 ("cudaMemcpyAsync", 76 * ms, 89 * ms), ("cudaLaunchKernel", 80 * ms, 81 * ms)])
    cell = harness.load_cell("fly_conv.pinned_T32")
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=32, trace=tr, window_s=0.1)
    assert harness.metric_reader("device_idle_pct")(ctx) == pytest.approx(70.0)
    assert harness.metric_reader("h2d_ms")(ctx) == pytest.approx(5.0)
    launch_ms, note = harness.metric_reader("host_call_ms")(ctx)
    assert launch_ms == pytest.approx(3.0) and "1.5 launch calls a call" in note
    bound, note = harness.metric_reader("roofline_pct.bottleneck")(ctx)
    assert 0 < bound and "of 31 blocks bound by" in note and "62 blocks in 2 calls" in note
    assert devtrace.busy_ns(tr.kernels + tr.copies) == 41 * ms
    b = devtrace.breakdown(tr, progspans.idle_by_span(progspans.of(ctx), tr))
    assert b["device_ops"][0] == ["bottleneck_kernel", pytest.approx(0.025)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    # 20-25, 42-44, 51-60, 70-74 in a df3d.call; 25-42 in the estimate; 44-45, 50-51, 74-75
    # in a call outside the program; 75-90 copying back; 45-50 and 90-100 between calls
    assert gaps == {"df3d.register.estimate": pytest.approx(0.017),
                    "df3d.call": pytest.approx(0.020), "perfbench.call": pytest.approx(0.003),
                    "perfbench.to_host": pytest.approx(0.015),
                    "outside_the_calls": pytest.approx(0.015)}
    assert sum(gaps.values()) == pytest.approx(0.07)


def test_a_traced_windows_idle_is_named_by_the_programs_spans(call_clock):
    """On the CPU no kernel runs: the whole window is idle, and the breakdown
    puts it down to the program's ``df3d.*`` spans, the benchmark's own
    where none holds it, and the time between the calls."""
    result, _ = _run(traced=True, seconds=1.0)
    names = [n for n, _ in result["breakdown"]["idle_gaps"]]
    assert {"df3d.net", "df3d.preprocess", "df3d.register.estimate"} <= set(names)
    assert all(n.startswith("df3d.") or n in ("perfbench.call", "perfbench.to_host",
                                              "outside_the_calls") for n in names)
    total = sum(v for _, v in result["breakdown"]["idle_gaps"])
    assert 0 < total <= result["device"]["window_s"]


@pytest.mark.gpu
def test_the_tf32_control_is_not_correct(card):
    """The reference computed with TF32 on, in the program's place, on the
    card at T=2 of the 256-wide cell: it fails at least one number."""
    import readings

    cell = tiny_cell("df2d256.dev_T16", T=2, chunks=2)
    s = harness.setup(cell, SEED, card)
    refs = cell.entry.reference(cell, s.pool, s.made, card, harness.ROOT)
    ctrl = cell.entry.reference(cell, s.pool, s.made, card, harness.ROOT, tf32=True)
    couts = cell.entry.control_outputs(ctrl)
    assert readings._numbers(cell, couts, [0, 1], refs)["correct"] is False
