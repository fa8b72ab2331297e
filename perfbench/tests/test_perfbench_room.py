"""A configuration brings its own path in new files only.

A toy configuration is written into a copy of ``perfbench/``: its sizes, a
seeded builder with ``shapes``, an entry whose program is the port's folded
hourglass (it imports ``deepfly3d_torch``), a frame source, its limits, a
traffic mix, and a ``BENCHMARK.json`` that names its one cell.  The copy is
then held to the rules the repository's tree is held to, by its own tests
(imports, the assembled cell, the counts), and a 2-call window of the toy
cell on the CPU is judged ``correct``: all in a process of its own whose
root is the copy.  No file the copy took from the repository is edited.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import harness

SEED = 2 ** 31 + 5051
CELL = "toy.T2"

FILES = {
    "configs/toy.json": {
        "name": "toy",
        "source": "https://arxiv.org/abs/1603.06937",
        "about": "A toy stacked hourglass at a test's size: 2 stacks, 16 features, depth 3, "
                 "the published stem at 4, 8, 8, 64x128 input, float32.",
        "builder": "toy_seeded",
        "spec": {"num_stacks": 2, "features": 16, "depth": 3, "num_blocks": 1,
                 "num_classes": 19, "expansion": 2, "stem": "conv", "stem_channels": [4, 8, 8],
                 "input_shape": [64, 128], "proj_from_raw": True},
        "dtype": "float32",
        "tf32": False,
        "num_cameras": 2,
        "image_hw": [64, 128],
        "data_sha256": {},
        "reduced": [],
    },
    "limits/toy.json": {"conf_err": 1e-3},
    "traffic/toy_T2.json": {
        "name": "toy_T2", "entry": "toy_net", "source": "toy_frames", "T": 2, "chunks": 2,
        "pool": "device", "max_roll_px": 2, "gain": [0.9, 1.1], "noise_levels": 3,
        "recording_sha256": "toy-frames-1",
    },
    "builders/toy_seeded.py": '''
        """Toy weights: the torch stacked hourglass of ``seeded_torch``, drawn from the seed."""
        from builders import seeded_torch
        from reference.hourglass import TorchLayout


        def make(cfg, root, seed, device):
            sd = seeded_torch.state_dict(cfg["spec"], seed, device)
            return {"layout": TorchLayout(sd), "state_dict": sd}


        def shapes(cfg, root):
            return seeded_torch.shapes(cfg, root)
        ''',
    "sources/toy_frames.py": '''
        """Toy frames: 4 frames of 2 cameras at the net's input size, fixed noise."""
        import numpy as np


        def load(root):
            return np.random.default_rng(5).integers(0, 256, (4, 2, 64, 128, 3), dtype=np.uint8)


        def digest(root):
            return "toy-frames-1"
        ''',
    "entries/toy_net.py": '''
        """A toy path: the port's folded hourglass on frames at its input size;
        per image and joint, the last stack's heatmap maximum."""
        import numpy as np
        import torch

        NAMES = ("conf_err",)
        MAXED = ()
        SUMMED = ()


        def build(cell, root, made, device):
            from deepfly3d_torch.models.convert_torch import convert_state_dict
            from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
            from deepfly3d_torch.models.hourglass import HourglassSpec

            s = cell.cfg["spec"]
            spec = HourglassSpec(num_stacks=s["num_stacks"], features=s["features"],
                                 depth=s["depth"], num_classes=s["num_classes"],
                                 proj_from_raw=s["proj_from_raw"])
            sd = {k: v.cpu().numpy() for k, v in made["state_dict"].items()}
            params, stats = convert_state_dict(sd, spec)
            net = FoldedHourglass(fold_hourglass({"params": params, "batch_stats": stats}, spec),
                                  spec).eval()

            def call(chunk):
                with torch.no_grad():
                    return (net(chunk.flatten(0, 1).float() / 255.0)[-1].amax(dim=(1, 2)),)
            return call


        def reference(cell, pool, made, device, root, tf32=False):
            from reference import hourglass

            net = hourglass.Hourglass(made["layout"], cell.cfg["spec"], True)
            with torch.no_grad():
                return [net.forward(c.flatten(0, 1).permute(0, 3, 1, 2).float() / 255.0)
                        .amax(dim=(2, 3)).numpy() for c in pool]


        def judge_call(cell, arrays, refs, k):
            return {"conf_err": float(np.abs(arrays[0] - refs[k]).max())}


        def keep(program):
            return None


        def notes(got, kept, refs):
            return ["toy net judged " + str(got["distinct_outputs"]) + " outputs"]


        def faults(cell, s, outs):
            return {}


        def control_outputs(refs):
            return [(r,) for r in refs]


        def golden(cell, s, root):
            return None
        ''',
}

RUN = '''
import json
import os
import sys

here = os.path.join(sys.argv[1], "perfbench")
sys.path[:0] = [here, os.path.join(here, "tests")]
import pytest

rules = pytest.main(["-q", "-rA", "-p", "no:cacheprovider", "-p", "no:randomly"]
                    + [os.path.join(here, "tests", f"test_perfbench_{t}.py")
                       for t in ("imports", "cells", "counts")])
import torch

import conftest
import harness
import run

harness.time = conftest.CallClock()
cell = harness.load_cell(sys.argv[2])
result, lines = run.run_cell(cell, int(sys.argv[3]), 0.5, False, torch.device("cpu"))
print("ROOM " + json.dumps({"rules": int(rules), "result": result, "lines": lines}))
'''


def _digests(top):
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = hashlib.sha256(fh.read()).digest()
    return out


def _bench_file():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "toy", "source": FILES["configs/toy.json"]["source"],
                         "file": "perfbench/configs/toy.json", "reduced": [],
                         "why": "a toy stacked hourglass through an entry of its own"}]
    bench["workloads"] = [{"name": CELL, "config": "toy", "traffic": "toy_T2", "chips": 1,
                           "why": "closed loop, 2 frames x 2 cameras a call from device memory"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    return bench


def test_a_configuration_brings_its_own_path_in_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    taken = _digests(root / "perfbench")
    assert taken == _digests(harness.HERE)
    for rel, body in FILES.items():
        path = root / "perfbench" / rel
        assert not path.exists(), rel
        path.write_text(json.dumps(body) if isinstance(body, dict) else textwrap.dedent(body))
    (root / "BENCHMARK.json").write_text(json.dumps(_bench_file()))
    before = _digests(root)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [harness.ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    done = subprocess.run([sys.executable, "-c", RUN, str(root), CELL, str(SEED)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=900)
    found = [ln for ln in done.stdout.splitlines() if ln.startswith("ROOM ")]
    assert done.returncode == 0 and found, done.stdout[-4000:] + done.stderr[-4000:]
    got = json.loads(found[-1][len("ROOM "):])
    assert got["rules"] == 0, done.stdout[-6000:]
    for case in ("cells.py::test_cell_is_assembled_from_its_files[toy.T2]",
                 "counts.py::test_forward_flops_equal_torchs_count_over_the_reference[toy]",
                 "counts.py::test_blocks_are_the_references[toy]",
                 "counts.py::test_frozen_counts_equal_the_programs[toy]",
                 "imports.py::test_no_jax_in_the_benchmark[entries/toy_net.py]",
                 "imports.py::test_only_entry_modules_import_the_program[builders/toy_seeded.py]"):
        assert f"PASSED perfbench/tests/test_perfbench_{case}" in done.stdout, case
    result = got["result"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 2
    assert list(result["checks"]) == ["conf_err"]
    assert "toy net judged 2 outputs" in got["lines"]
    assert _digests(root) == before
