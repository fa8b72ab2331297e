"""The port's contract, probe and timing harness (``deepfly3d_torch/bench.py``)
against the JAX package's (``bench.py``), on the CPU.

* the golden frames and each of the six held-out probes' frames bit-equal
  to JAX's ``load_probe_frames``, with the same names and gates, and equal
  to the SHA-256 digests in the committed reference
  ``deepfly3d_torch/data/bench_probes_conv.json``, which the chip smoke run
  checks on the card;
* ``verify_contract`` / ``verify_probes`` reports equal between the two
  packages on the same stub pipeline, with errors planted per probe;
* the FLOPs counted from the spec equal ``torch.utils.flop_counter`` over
  the plain folded forward (every block an ``F.conv2d`` and matmuls) for the
  conv, p16 and cascade-student specs at 16 features;
* ``pipeline_mfu`` divides by an H100 peak; ``measure_fps`` on a stub;
* ``bench_bundle_adjust``: both solvers, each with a falling cost.

The committed reference holds JAX's ``verify_contract`` on the golden
frames and on each probe through JAX's ``build_pipeline`` with
``weights/hourglass_fly.npz`` (float32, rig registration on), unrounded,
and the probes' digests.  Regenerate it with ``python
tests/test_torch_bench.py --write`` (~1 min of JAX on the CPU).  ~55 s.
"""

import dataclasses
import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepfly3d_torch import bench as port_bench  # noqa: E402

PROBES_REF = os.path.join(REPO, "deepfly3d_torch", "data", "bench_probes_conv.json")
PROBE_NAMES = ["reencode", "jpeg_q90", "shift-2px", "shift+2px", "gain0.95", "gain1.05"]
# planted per probe: (points error, confidence error) -> the gates' verdicts
PLANTED = {"reencode": (0.01, 0.007), "jpeg_q90": (0.03, 0.0), "shift-2px": (0.022, 0.001),
           "shift+2px": (0.0225, 0.0), "gain0.95": (0.0, 0.5), "gain1.05": (0.019, 0.0),
           "golden": (0.0, 0.0021)}


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads for torch and for the BLAS under numpy and scipy
    (the fit's many small products): the suite runs 6 workers on the cores,
    and 8 threads each oversubscribe them.  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(before)


def _jax_bench():
    """The JAX harness; importing it sets DF3D_TPU_DISABLE_X64 for its own
    process, which the caller restores (tests/test_bench_probes.py)."""
    had = os.environ.get("DF3D_TPU_DISABLE_X64")
    try:
        import bench

        return bench
    finally:
        if had is None:
            os.environ.pop("DF3D_TPU_DISABLE_X64", None)
        else:
            os.environ["DF3D_TPU_DISABLE_X64"] = had


def digest(frames) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def probes():
    return {"port": port_bench.load_probe_frames(), "jax": _jax_bench().load_probe_frames()}


@pytest.fixture(scope="module")
def reference():
    with open(PROBES_REF) as f:
        return json.load(f)


def test_golden_frames_equal(reference):
    frames, golden = port_bench.load_golden_frames()
    want, want_golden = _jax_bench().load_golden_frames()
    assert frames.shape == (15, 7, 480, 960, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, want)
    assert sorted(golden) == sorted(want_golden)
    np.testing.assert_array_equal(golden["points2d"], want_golden["points2d"])
    assert digest(frames) == reference["golden"]["sha256"]


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_probe_frames_bit_equal_to_jax(probes, reference, name):
    assert list(probes["port"]) == list(probes["jax"]) == PROBE_NAMES
    frames, pts_tol, conf_tol = probes["port"][name]
    want, want_pts, want_conf = probes["jax"][name]
    assert frames.dtype == np.uint8 and frames.shape == (15, 7, 480, 960, 3)
    np.testing.assert_array_equal(frames, want)
    assert (pts_tol, conf_tol) == (want_pts, want_conf)
    assert digest(frames) == reference["probes"][name]["sha256"]


def _stub(golden, by_digest, to_out):
    """A pipeline stub: the golden result plus the error planted for the frames' digest."""
    def pipeline(frames):
        dp, dc = by_digest[digest(np.asarray(frames))]
        p38 = np.asarray(golden["points2d"], np.float32) + np.float32(dp)
        conf = np.asarray(golden["heatmap_confidence"], np.float32) + np.float32(dc)
        return to_out(None), to_out(p38), to_out(conf)
    return pipeline


def test_reports_equal_on_a_stub_pipeline(probes):
    jb = _jax_bench()
    frames, golden = port_bench.load_golden_frames()
    by_digest = {digest(p[0]): PLANTED[n] for n, p in probes["port"].items()}
    by_digest[digest(frames)] = PLANTED["golden"]
    port_pipe = _stub(golden, by_digest, lambda a: None if a is None else torch.from_numpy(a))
    jax_pipe = _stub(golden, by_digest, lambda a: a)
    got = port_bench.verify_contract(port_pipe, frames, golden)
    assert got == jb.verify_contract(jax_pipe, frames, golden)
    assert got[2] is False                         # conf 0.0021 > 0.002
    report, all_pass = port_bench.verify_probes(port_pipe, probes["port"], golden)
    assert (report, all_pass) == jb.verify_probes(jax_pipe, probes["jax"], golden)
    assert {n: r["pass"] for n, r in report.items()} == {
        "reencode": False, "jpeg_q90": False, "shift-2px": True, "shift+2px": False,
        "gain0.95": True, "gain1.05": True}
    assert not all_pass


def test_reencode_left_out_without_its_jpegs(monkeypatch):
    """JAX's fallback, kept: no expanded JPEGs, no ``reencode`` probe."""
    from deepfly3d_torch.io import discovery

    monkeypatch.setattr(discovery, "expand_videos", lambda folder, *a, **k: None)
    assert list(port_bench.load_probe_frames()) == PROBE_NAMES[1:]


# ------------------------------------------------------------------ FLOPs


def _spec(name):
    from deepfly3d_torch.models.hourglass import load_weights

    spec = load_weights(os.path.join(REPO, "weights", name + ".npz"))[1]
    return dataclasses.replace(spec, features=16)


@pytest.mark.parametrize("name", ["hourglass_fly", "hourglass_fly_p16_tpu",
                                  "hourglass_fly_fast_nearparity"])
def test_spec_flops_equal_the_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
    from deepfly3d_torch.models.hourglass import init_params
    from deepfly3d_torch.ops.bottleneck import bottleneck_plain
    from deepfly3d_torch.ops.kernels import upsample2x_add_plain

    spec = _spec(name)
    shape = (128, 256)              # depth 4 from the patch16 stem's 1/8 still leaves 1x2
    variables = init_params(spec, shape, torch.Generator().manual_seed(0), device="cpu")
    as_np = lambda t: {k: as_np(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}
    net = FoldedHourglass(fold_hourglass(as_np(variables), spec), spec)
    net.block_fn, net.merge_fn = bottleneck_plain, upsample2x_add_plain
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.rand((2,) + shape + (3,)))
    got = port_bench.forward_flops(spec, 2, shape)
    assert got["stem"] + got["blocks"] + got["heads"] == counter.get_total_flops()
    assert got["total"] == sum(v for k, v in got.items() if k != "total") and got["adds"] > 0


def test_pipeline_flops_and_mfu_on_an_h100_peak():
    student, teacher = _spec("hourglass_fly_fast_nearparity"), _spec("hourglass_fly")
    pipe = types.SimpleNamespace(
        net=types.SimpleNamespace(spec=student), teacher=types.SimpleNamespace(spec=teacher),
        input_shape=(192, 384), teacher_shape=(256, 512), num_cameras=7,
        image_hw=(480, 960), cfg=types.SimpleNamespace(repair_frac=0.125),
        device=torch.device("cpu"))
    flops = port_bench.pipeline_flops(pipe, 2)
    want_fwd = (port_bench.forward_flops(student, 14, (192, 384))["total"]
                + port_bench.forward_flops(teacher, 2, (256, 512))["total"])
    assert flops["forward"] == want_fwd
    assert flops["preprocess"] == (port_bench.preprocess_flops(14, (480, 960), (192, 384))
                                   + port_bench.preprocess_flops(2, (480, 960), (256, 512)))
    out = port_bench.pipeline_mfu(pipe, torch.zeros((2, 7, 1, 1, 3)), 3, 0.5)
    assert out["peak_flops"] == 67e12 and out["peak_flops"] != 181e12
    assert out["mfu"] == pytest.approx(flops["total"] * 3 / 0.5 / 67e12)
    assert "H100" in out["peak_of"] and out["card"] == "cpu" and out["arithmetic"] == "float32"
    pipe.net.spec = dataclasses.replace(student, compute_dtype="bfloat16")
    assert port_bench.pipeline_mfu(pipe, torch.zeros((2,)), 1, 1.0)["peak_flops"] == 989e12


def test_measure_fps_on_a_stub():
    seen = []

    def pipeline(frames):
        seen.append(frames)
        return frames

    pipeline.device = torch.device("cpu")
    fps, frames, iters, dt = port_bench.measure_fps(pipeline, 2, iters=3)
    assert iters == 3 and len(seen) == 4 and fps == pytest.approx(2 * 3 / dt)
    assert frames.shape == (2, 7, 480, 960, 3) and frames.dtype == torch.uint8
    assert int(frames.max()) <= 254
    assert torch.equal(frames, port_bench.measure_fps(pipeline, 2, iters=1)[1])


def test_bench_bundle_adjust_both_solvers():
    timings = port_bench.bench_bundle_adjust(n_samples=1)
    assert sorted(timings) == ["lm", "parity"]
    for med, spread in timings.values():
        assert med > 0 and spread == 0.0


# ------------------------------------------------------------------ --write


def write_reference():
    """JAX's contract and probes on the conv checkpoint -> PROBES_REF."""
    import pickle

    jb = _jax_bench()
    from deepfly3d_tpu.models.hourglass import load_weights
    from deepfly3d_tpu.ops import geometry

    variables, spec = load_weights(os.path.join(REPO, "weights", "hourglass_fly.npz"))
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    frames, golden = jb.load_golden_frames()
    pipe = jb.build_pipeline(spec, variables, calib, golden["camera_ordering"], (256, 512))
    pts, conf, ok = jb.verify_contract(pipe, frames, golden)
    out = {"checkpoint": "weights/hourglass_fly.npz",
           "golden": {"sha256": digest(frames), "pts_err": pts, "conf_err": conf, "pass": ok},
           "probes": {}}
    for name, (pf, pts_tol, conf_tol) in jb.load_probe_frames().items():
        pts, conf, _ = jb.verify_contract(pipe, pf, golden)
        out["probes"][name] = {"sha256": digest(pf), "pts_err": pts, "conf_err": conf,
                               "pts_tol": pts_tol, "conf_tol": conf_tol}
        print(name, out["probes"][name], flush=True)
    with open(PROBES_REF, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {PROBES_REF}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        write_reference()
