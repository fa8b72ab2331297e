"""The h36m configuration's own files: its frames, its seeded weights, its
frozen FLOP count by hand, a CPU window judged ``correct``, every planted
fault caught, and the ``undistort_ms`` reader on a hand-made trace."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import harness
import yardstick
from conftest import tiny_cell

SEED = 2 ** 31 + 977
TINY = dict(features=16, depth=2, stem_channels=[8, 16, 16], input_shape=[64, 64])


def test_the_source_is_the_programs_human_frames():
    """``sources/human_recording.py`` gives, byte for byte, what
    ``utils/synthetic.human_frames`` gives at its seed and size."""
    from deepfly3d_torch.utils import synthetic

    import generator

    cell = harness.load_cell("h36m.dev_B32")
    source = generator.source(cell.mix)
    got = source.load(harness.ROOT)
    assert got.shape == (15, 4, 1000, 1000, 3) and got.dtype == np.uint8
    assert source.digest(harness.ROOT) == cell.mix["recording_sha256"]
    want_digest = hashlib.sha256(got.tobytes()).hexdigest()
    del got
    want, _, _ = synthetic.human_frames(source.SEED, source.FRAMES, synthetic.human_rig())
    assert hashlib.sha256(np.ascontiguousarray(want.transpose(1, 0, 2, 3, 4)).tobytes()) \
        .hexdigest() == want_digest


def test_the_builder_draws_as_the_programs_random_checkpoint(tmp_path):
    from deepfly3d_torch.utils import synthetic

    import builders.seeded_flax as seeded

    spec = dict(num_stacks=2, features=8, depth=2, num_blocks=1, num_classes=17, expansion=2,
                stem="conv", stem_channels=[4, 8, 8], input_shape=[32, 32])
    got = seeded.arrays(spec, 12345)
    want = synthetic.random_checkpoint(str(tmp_path / "c.npz"), 12345, 2, 8, 2, 17, (32, 32))
    weights = {k: v for k, v in got.items() if not k.startswith("__spec__/")}
    assert list(weights) == list(want)
    assert all(np.array_equal(weights[k], want[k]) for k in want)
    with np.load(tmp_path / "c.npz") as z:
        assert {k: z[k].tolist() for k in z.files if k.startswith("__spec__/")} == \
            {k: v.tolist() for k, v in got.items() if k.startswith("__spec__/")}
    with pytest.raises(ValueError, match="flax layout"):
        seeded.arrays(dict(spec, stem_channels=[64, 128, 128]), 1)


def test_a_calls_flops_by_hand():
    """32 frames x 4 cameras at 384x384: the stem convolution, 59 blocks
    (the stem's 64->128 at 192x192 and two 128->128 at 96x96; per stack
    27,612 block-pixels of 128->128 at 96..6), the heads and the adds;
    2.695 TFLOP of forward, and the preprocess's resize taps."""
    cell = harness.load_cell("h36m.dev_B32")
    n = 32 * 4
    stem = 192 * 192 * 49 * 3 * 64
    per_stack = 2 * 96 ** 2 + 3 * (48 ** 2 + 24 ** 2 + 12 ** 2 + 6 ** 2)
    assert per_stack == 27612
    mac128, mac64 = 64 * 128 + 9 * 64 * 64 + 64 * 128, 64 * 64 + 9 * 64 * 64 + 64 * 128 + 64 * 128
    blocks = 192 ** 2 * mac64 + 2 * 96 ** 2 * mac128 + 4 * per_stack * mac128
    heads = 96 ** 2 * (3 * 2 * (128 * 128 + 128 * 17) + (128 * 128 + 128 * 17))
    adds = 4 * 128 * (96 ** 2 + 48 ** 2 + 24 ** 2 + 12 ** 2) + 3 * 2 * 96 ** 2 * 128
    forward = n * (2 * stem + 2 * blocks + 2 * heads + adds)
    assert forward == 2_695_004_946_432
    assert len(yardstick.blocks(cell.cfg["spec"], (384, 384))) == 59
    assert yardstick.forward_flops(cell.cfg["spec"], n, (384, 384))["total"] == forward
    taps = 2 * 3 * n * (384 * 1000 * 6 + 384 * 384 * 6)
    assert yardstick.resize_taps_width(1000, 384) == 6
    assert yardstick.call_flops(cell.cfg, 32) == forward + taps == 2_697_453_895_680


def _tiny_cell():
    return tiny_cell("h36m.dev_B32", T=2, chunks=2, **TINY)


def test_a_cpu_window_is_correct_and_every_fault_fails_a_limit(call_clock):
    import run

    cell, cpu = _tiny_cell(), torch.device("cpu")
    result, _ = run.run_cell(cell, SEED, 1.0, False, cpu)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 4
    assert list(result["checks"]) == list(cell.entry.NAMES)
    s = harness.setup(cell, SEED, cpu)
    outs = [harness.to_host(s.prog(chunk)) for chunk in s.pool]
    faults = cell.entry.faults(cell, s, outs)
    refs = cell.entry.reference(cell, s.pool, s.made, cpu, harness.ROOT)
    assert harness.judge(cell, outs, [0, 1], refs)["correct"] is True
    assert set(faults) == {"stale", "half_batch", "moved_2d_point", "moved_3d_frame",
                           "zeroed_3d_frame", "undistortion_skipped"}
    for name, fouts in faults.items():
        got = harness.judge(cell, fouts, [0, 1], refs)
        assert got["correct"] is False, name


def test_the_outputs_layout_and_a_point_at_infinity():
    """17 joints on 4 cameras with no assembly; a null vector at infinity
    is not judged by p3d_err (its separation reads 0) and its finite stand-in
    has no residual above the least."""
    from reference import human_pipeline as ref

    cell = _tiny_cell()
    rig = ref.load_rig(cell.cfg)
    p2d = np.zeros((4, 1, 2, 2), np.float32)
    # joint 0: the opposite cameras 0 and 2 see one cell, 1 and 3 another: a seeded net's
    # cells whose least-squares null vector lies at infinity; joint 1: every camera's centre
    p2d[:, 0, 0] = [[0.1875, 0.0625], [0.375, 0.5625], [0.1875, 0.0625], [0.375, 0.5625]]
    p2d[:, 0, 1] = 0.5
    tri, separation = ref.triangulate(p2d, rig, (1000, 1000))
    assert np.isfinite(tri).all() and separation[0, 0] == 0.0 and separation[0, 1] >= 4
    assert np.abs(tri[0, 1]).max() < 1e-9                    # every ray through the centre
    assert ref.residual_excess(p2d, tri, rig, (1000, 1000)).max() < 1e-6


def test_undistort_ms_on_a_hand_made_trace():
    """Two calls; 3 ms of kernels launched inside ``df3d.undistort`` in
    each, 1 ms in ``df3d.triangulate``; nothing where no such span launched."""
    ms = 1_000_000
    spans = [("df3d.call", 0, 40 * ms, 1), ("df3d.undistort", 10 * ms, 20 * ms, 1),
             ("df3d.triangulate", 20 * ms, 30 * ms, 1),
             ("df3d.call", 50 * ms, 90 * ms, 1), ("df3d.undistort", 60 * ms, 70 * ms, 1)]
    launches = {i: ("cudaLaunchKernel", s * ms, (s + 1) * ms)
                for i, s in ((1, 11), (2, 21), (3, 61), (4, 63))}
    work = [("vectorized_elementwise_kernel", 12 * ms, 15 * ms, 1),
            ("reduce_kernel", 22 * ms, 23 * ms, 2),
            ("vectorized_elementwise_kernel", 62 * ms, 64 * ms, 3),
            ("vectorized_elementwise_kernel", 64 * ms, 65 * ms, 4)]
    tr = SimpleNamespace(window=(0, 100 * ms), calls=2, work=work, launch_api=launches,
                         kernels=[w[:3] for w in work], copies=[], spans=[], runtime=[],
                         program_spans=spans)
    cell = harness.load_cell("h36m.dev_B32")
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=32, trace=tr, window_s=0.1)
    value, note = harness.metric_reader("undistort_ms")(ctx)
    assert value == pytest.approx(3.0)
    assert note.startswith("df3d.undistort: 1.5 launch calls a call")
    fields = {k: v for k, v in vars(tr).items() if k != "program"}    # the spans read once
    fields["program_spans"] = [sp for sp in spans if sp[0] != "df3d.undistort"]
    tr2 = SimpleNamespace(**fields)
    ctx2 = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=32, trace=tr2, window_s=0.1)
    assert harness.metric_reader("undistort_ms")(ctx2) is None
