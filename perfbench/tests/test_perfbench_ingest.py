"""The ``estimator`` entry (the CLI's ingest) and what makes room for it, on the CPU.

Whole runs of a tiny ingest cell: the fly cell's traffic at T=8 (enough
frames for the host registration) over a seeded 16-wide checkpoint, written
beside a copy of the rig template as a lab's checkpoint folder holds one.
The window is timed by ``conftest.CallClock``: a fixed number of calls.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

import entries
import generator
import harness
import run
from conftest import mix_cell, tiny_cell

SEED = 2 ** 31 + 4099
SPEC = dict(num_stacks=2, features=16, depth=3, num_blocks=1, num_classes=19, stem="conv",
            stem_channels=[8, 16, 16], input_shape=[64, 128], proj_from_raw=False)


@pytest.fixture
def ingest_cell(tmp_path):
    from deepfly3d_torch.utils import synthetic

    path = str(tmp_path / "hourglass_tiny.npz")
    synthetic.random_checkpoint(path, 11, 2, 16, 3, 19, (64, 128))
    cell = mix_cell("fly_conv.pinned_T32", "ingest_b8")
    cell.mix = dict(cell.mix, T=8, chunks=2)
    shutil.copy(os.path.join(harness.ROOT, cell.cfg["rig_template"]), tmp_path)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    cell.cfg = dict(cell.cfg, checkpoint=path, checkpoint_sha256=digest, spec=SPEC)
    return cell


def _run(cell, break_program=None, traced=False):
    return run.run_cell(cell, SEED, 1.0, traced, torch.device("cpu"),
                        break_program=break_program)


def test_an_ingest_run_is_correct(ingest_cell, call_clock):
    result, lines = _run(ingest_cell)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 4
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(result["checks"]) == ["conf_err", "cell_gap"]
    assert set(result["metrics"]) == {"frames_per_s", "call_ms_p95", "peak_mem_gib", "setup_s"}
    assert any("agree on every camera" in line for line in lines)
    assert lines[-2:] == [f"check {n}: {c['value']!r} limit {c['limit']!r}"
                          for n, c in result["checks"].items()]
    json.loads(json.dumps(result))


def test_a_traced_ingest_run_is_correct(ingest_cell, call_clock):
    result, _ = _run(ingest_cell, traced=True)
    assert result["correct"] is True
    # a CPU trace holds no device work: only the FLOP count finds something to read
    assert set(result["metrics"]) == {"mfu_pct"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_run_registers_a_drifted_recording(ingest_cell):
    """The seed's rig drifted: the host estimate shifts and scales, so the
    gain fault below has something to divide."""
    cpu = torch.device("cpu")
    s = harness.setup(ingest_cell, SEED, cpu)
    harness.warm_up(s)
    reg = ingest_cell.entry.keep(s.prog)
    assert sorted(reg) == list(range(7))
    assert any(g != 1.0 for _, _, g in reg.values())
    assert any(dy or dx for dy, dx, _ in reg.values())


class _Stale:
    """Hands back the previous call's outputs: a call that returns its state unchanged."""

    def __init__(self, prog):
        self.prog, self.last = prog, None

    def __call__(self, frames):
        out, self.last = self.last, self.prog(frames)
        return self.last if out is None else out


def _moved_point(prog):
    def call(frames):
        pts, conf = prog(frames)
        pts = pts.copy()
        pts[0, 0, 0, 0] += 1.0 / 16                          # one heatmap row down
        return pts, conf
    return call


def _gain_divided(prog):
    ingest = entries.of({"entry": "estimator"})
    ingest.divide_gain(prog)
    return prog


@pytest.mark.parametrize("fault", [_Stale, _moved_point, _gain_divided],
                         ids=["state_unchanged", "answer_altered", "gain_divided"])
def test_a_broken_ingest_is_not_correct(ingest_cell, call_clock, fault):
    result, _ = _run(ingest_cell, break_program=fault)
    assert result["correct"] is False and result["failed"] > 0


def test_the_cells_own_checkpoint_builds():
    """``weights/hourglass_fly.npz`` stores no input shape: the program's default is the
    configuration's."""
    cell = mix_cell("fly_conv.pinned_T32", "ingest_b8")
    cpu = torch.device("cpu")
    made = harness.builder(cell.cfg).make(cell.cfg, harness.ROOT, 1, cpu)
    prog = cell.entry.build(cell, harness.ROOT, made, cpu)
    assert prog.est.input_shape == (256, 512) and prog.flip_ids == [4, 5, 6]


def test_a_state_dict_configuration_names_the_missing_step():
    cell = tiny_cell("df2d256.dev_T16")
    cell.entry = entries.of({"entry": "estimator"})
    with pytest.raises(ValueError, match="convert_checkpoint"):
        cell.entry.build(cell, harness.ROOT, {"state_dict": {}}, torch.device("cpu"))


def _flat_recording(value=200):
    """2 frames of 7 cameras, 32x48, flat but for one bright pixel per camera."""
    rec = torch.full((2, 7, 32, 48, 3), value, dtype=torch.uint8)
    rec[:, :, 5, 7] = 255
    return rec


def _mix(**kw):
    return dict(dict(T=2, chunks=4, pool="device", max_roll_px=4, gain=[0.5, 0.9],
                     noise_levels=0), **kw)


def _drift(chunk):
    """Per camera: where the bright pixel went (the roll) and the flat level (the gain)."""
    x = np.asarray(chunk)[0, ..., 0]                                  # (C, H, W)
    where = [np.unravel_index(int(x[c].argmax()), x[c].shape) for c in range(len(x))]
    return [tuple(map(int, w)) for w in where], [int(x[c].min()) for c in range(len(x))]


def test_recording_drift_holds_one_roll_and_gain_for_the_pool():
    pool = generator.make_pool(_flat_recording(), _mix(drift="recording"), SEED)
    assert all(_drift(chunk) == _drift(pool[0]) for chunk in pool)
    per_chunk = generator.make_pool(_flat_recording(), _mix(), SEED)
    assert len({str(_drift(chunk)) for chunk in per_chunk}) == len(per_chunk)


def test_chunk_drift_is_the_default():
    rec = _flat_recording(100)
    a = generator.make_pool(rec, _mix(noise_levels=3), SEED)
    b = generator.make_pool(rec, _mix(noise_levels=3, drift="chunk"), SEED)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_host_pool_is_pageable_numpy_in_camera_major_order():
    rec = _flat_recording(100)
    dev = generator.make_pool(rec, _mix(noise_levels=3), SEED)
    host = generator.make_pool(rec, _mix(noise_levels=3, pool="host"), SEED)
    for d, h in zip(dev, host):
        assert isinstance(h, np.ndarray) and h.shape == tuple(d.shape)
        assert np.array_equal(h, d.numpy())
        assert h.transpose(1, 0, 2, 3, 4).flags.c_contiguous


TOY_ENTRY = '''
"""A toy path: each frame's mean level per camera."""
import numpy as np
import torch

NAMES = ("level_err",)
MAXED = ()
SUMMED = ()


def build(cell, root, made, device):
    return lambda chunk: (torch.as_tensor(chunk).float().mean(dim=(2, 3, 4)),)


def reference(cell, pool, made, device, root, tf32=False):
    return [np.asarray(chunk, np.float64).mean(axis=(2, 3, 4)) for chunk in pool]


def judge_call(cell, arrays, refs, k):
    return {"level_err": float(np.abs(arrays[0] - refs[k]).max())}


def keep(program):
    return None


def notes(got, kept, refs):
    return ["toy entry judged " + str(got["distinct_outputs"]) + " outputs"]


def faults(cell, s, outs):
    return {}


def control_outputs(refs):
    return list(refs)


def golden(cell, s, root):
    return None
'''

TOY_SOURCE = '''
"""A toy source: 3 flat frames of 2 cameras."""
import numpy as np


def load(root):
    return np.full((3, 2, 8, 8, 3), 90, np.uint8)


def digest(root):
    return "toy"
'''


def test_a_new_entry_and_source_are_found_by_name(tmp_path, monkeypatch, call_clock):
    """An entry and a frame source added as files, named by a traffic mix,
    run a whole cell through the harness as it stands."""
    (tmp_path / "entries").mkdir()
    (tmp_path / "sources").mkdir()
    (tmp_path / "entries" / "toy.py").write_text(TOY_ENTRY)
    (tmp_path / "sources" / "toy.py").write_text(TOY_SOURCE)
    cell = tiny_cell("fly_conv.dev_T32", T=2, chunks=2)
    monkeypatch.setattr(entries, "DIR", str(tmp_path / "entries"))
    monkeypatch.setattr(generator, "SOURCES", str(tmp_path / "sources"))
    cell.mix = dict(cell.mix, entry="toy", source="toy", recording_sha256="toy")
    cell.entry = entries.of(cell.mix)
    cell.cfg = dict(cell.cfg, data_sha256={})
    cell.limits = {"level_err": 1e-3}
    result, lines = _run(cell)
    assert result["correct"] is True and result["attempted"] == 4
    assert list(result["checks"]) == ["level_err"]
    assert "toy entry judged 2 outputs" in lines


def test_the_pipeline_runs_the_configurations_dtype(ingest_cell):
    """The configuration's ``dtype`` reaches the spec's ``compute_dtype``:
    float32 gives the bits of a pipeline built from the checkpoint's own
    spec, bfloat16 builds the bf16 path, and a dtype with no path is refused."""
    import pickle

    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    cpu = torch.device("cpu")
    cell = tiny_cell("fly_conv.dev_T32", T=2, chunks=1)
    cell.cfg = dict(ingest_cell.cfg)
    made = harness.builder(cell.cfg).make(cell.cfg, harness.ROOT, 1, cpu)
    chunk = generator.make_pool(torch.from_numpy(generator.source(cell.mix).load(harness.ROOT)),
                                cell.mix, SEED)[0]
    got = [t.numpy() for t in cell.entry.build(cell, harness.ROOT, made, cpu)(chunk)]
    with open(os.path.join(harness.ROOT, cell.cfg["calib"]), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    variables, spec = load_weights(made["checkpoint"])
    direct = build_pipeline(spec, variables, calib, cell.cfg["camera_ordering"],
                            rig=os.path.join(harness.ROOT, cell.cfg["rig_template"]), device=cpu)
    assert all(np.array_equal(a, t.numpy()) for a, t in zip(got, direct(chunk)))
    cell.cfg["dtype"] = "bfloat16"
    assert cell.entry.build(cell, harness.ROOT, made, cpu).net.spec.compute_dtype == "bfloat16"
    cell.cfg["dtype"] = "float16"
    with pytest.raises(ValueError, match="float16"):
        cell.entry.build(cell, harness.ROOT, made, cpu)
