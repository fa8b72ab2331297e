"""The h36m capture profile on the port's device pipeline, on the CPU.

``build_pipeline(..., profile="h36m", rig=None)`` (4 cameras, no flip, no
19->38 assembly, the observations undistorted before the float64 SVD DLT) is
held to the benchmark's plain reference, ``perfbench/reference/human_pipeline.py``
(plain PyTorch and NumPy, float64 undistortion and SVD DLT), on a seeded
random checkpoint at a small size: 4 stacks, 16 features, depth 2, 64x64
input, 4 cameras of 160x160 (the profile's frame size replaced), T=2,
barrel distortion k1 -0.15.

Tolerances, each with its reason:

* ``CONF_TOL`` 2e-6: the port's folded float32 forward against the
  reference's unfolded one differs by rounding, ~1e-7 at heatmap peaks of
  ~2; a bf16 forward is ~2e-3 off.
* ``CELL_TOL`` 2e-6: a 2D point may differ from the reference's only at a
  near-tie, where the reference's heatmap at the port's cell lies within
  rounding of its maximum.
* ``P3D_TOL`` 1e-6: the port's float64 undistortion (8 fixed-point steps)
  and SVD DLT against the reference's (converged) ones on the port's own 2D
  points, relative, where the equations determine the point (their
  singular values separate by 4x, as the benchmark's judge asks): ~4e-8,
  the points' float32 output; skipping the undistortion moves the points
  by ~6e-3.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from deepfly3d_torch import pipeline
from deepfly3d_torch.config import h36m_config
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(REPO, "perfbench")
SIZE, FOCAL, K1, T = 160, 224.0, -0.15, 2
SPEC = dict(num_stacks=4, features=16, depth=2, num_blocks=1, num_classes=17, stem="conv",
            input_shape=[64, 64])
CONF_TOL, CELL_TOL, P3D_TOL, SEPARATION = 2e-6, 2e-6, 1e-6, 4.0


def _reference():
    if PERFBENCH not in sys.path:
        sys.path.insert(0, PERFBENCH)
    return (importlib.import_module("reference.human_pipeline"),
            importlib.import_module("reference.hourglass"))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Weights, rig, frames (T, C, H, W, 3) and the reference's result."""
    torch.manual_seed(0)
    ref, hourglass = _reference()
    path = str(tmp_path_factory.mktemp("h36m") / "h36m.npz")
    arrays = synthetic.random_checkpoint(path, 7, SPEC["num_stacks"], SPEC["features"],
                                         SPEC["depth"], SPEC["num_classes"],
                                         tuple(SPEC["input_shape"]))
    rig_params = dict(num_cameras=4, size=SIZE, focal=FOCAL, distance=5.0, k1=K1)
    rig = synthetic.human_rig(**rig_params)
    frames, _, _ = synthetic.human_frames(11, T, rig, size=SIZE, sigma=3.0)
    frames = np.ascontiguousarray(frames.transpose(1, 0, 2, 3, 4))
    net = hourglass.Hourglass(hourglass.FlaxLayout({k: torch.from_numpy(v)
                                                    for k, v in arrays.items()}), SPEC, False)
    ref_rig = ref.load_rig({"rig": rig_params, "spec": SPEC})
    result = ref.run(torch.from_numpy(frames), net, ref_rig, (SIZE, SIZE))
    calib = geometry.calib_to_arrays(rig, 4, dtype=np.float32)
    return dict(path=path, calib=calib, frames=frames, ref=ref, ref_rig=ref_rig, result=result)


@pytest.fixture
def small_frames(monkeypatch):
    """The h36m profile with 160x160 frames."""
    monkeypatch.setitem(pipeline.PROFILES, "h36m",
                        lambda: dataclasses.replace(h36m_config(), image_hw=(SIZE, SIZE)))


def _pipe(case, **spec_changes):
    variables, spec = load_weights(case["path"])
    spec = dataclasses.replace(spec, **spec_changes)
    return pipeline.build_pipeline(spec, variables, case["calib"], [0, 1, 2, 3], rig=None,
                                   device="cpu", profile="h36m")


def _check(case, outs):
    """-> (conf error, worst cell gap, worst 3D error over determined points, determined count)."""
    ref, r, rig = case["ref"], case["result"], case["ref_rig"]
    p3d, p2d, conf = (t.numpy().astype(np.float64) for t in outs)
    conf_err = float(np.abs(conf - r.conf).max())
    hm = r.heatmaps
    h, w = hm.shape[2:]
    c, t, j = np.nonzero(np.abs(p2d - r.points2d).max(axis=-1) > 0)
    rows, cols = np.rint(p2d[c, t, j, 0] * h).astype(int), np.rint(p2d[c, t, j, 1] * w).astype(int)
    top = hm.flatten(2).max(dim=-1).values.double().numpy()
    at = hm[t * 4 + c, j, rows, cols].double().numpy()
    gap = float((top[t * 4 + c, j] - at).max(initial=0.0))
    tri, separation = ref.triangulate(p2d, rig, (SIZE, SIZE))
    judged = separation >= SEPARATION
    scale = np.maximum(np.linalg.norm(tri, axis=-1), np.median(np.linalg.norm(tri, axis=-1)))
    err = float((np.linalg.norm(p3d - tri, axis=-1) / scale)[judged].max(initial=0.0))
    return conf_err, gap, err, int(judged.sum())


def test_h36m_pipeline_matches_the_reference(case, small_frames):
    pipe = _pipe(case)
    assert pipe.distort is not None and not pipe.assemble and not bool(pipe.flip.any())
    p3d, p2d, conf = pipe(case["frames"])
    assert pipe.dlt == "svd" and pipe.R.dtype == torch.float64 and p3d.dtype == torch.float32
    assert p3d.shape == (T, 17, 3) and p2d.shape == (4, T, 17, 2) and conf.shape == (4, T, 17, 1)
    conf_err, gap, err, determined = _check(case, (p3d, p2d, conf))
    assert conf_err <= CONF_TOL and gap <= CELL_TOL and err <= P3D_TOL
    assert determined >= 10


def test_a_bf16_forward_fails_the_conf_tolerance(case, small_frames):
    outs = _pipe(case, compute_dtype="bfloat16")(case["frames"])
    assert _check(case, outs)[0] > 10 * CONF_TOL


def test_a_dlt_without_the_undistortion_fails_the_3d_tolerance(case, small_frames):
    pipe = _pipe(case)
    _, p2d, conf = pipe(case["frames"])
    raw = geometry.triangulate(p2d, pipe.R, pipe.tvec, pipe.intr, (SIZE, SIZE), method=pipe.dlt)
    assert _check(case, (raw, p2d, conf))[2] > 10 * P3D_TOL


def test_undistortion_is_the_identity_for_zero_coefficients(case, small_frames):
    """Zero coefficients: the port's normalised undistortion is exact, the
    pipeline undistorts nothing (no ``distort``), and the reference's pixels
    come back within rounding."""
    ref = case["ref"]
    xy = torch.rand(4, 3, 17, 2, dtype=torch.float32) - 0.5
    assert torch.equal(geometry.undistort_points(xy, torch.zeros(4, 5)), xy)
    R, tvec, intr, distort = case["calib"]
    pipe = pipeline.build_pipeline(*reversed(load_weights(case["path"])),
                                   (R, tvec, intr, np.zeros_like(distort)), [0, 1, 2, 3],
                                   rig=None, device="cpu", profile="h36m")
    assert pipe.distort is None
    p3d, p2d, _ = pipe(case["frames"])
    assert torch.equal(p3d, geometry.triangulate(p2d, pipe.R, pipe.tvec, pipe.intr, (SIZE, SIZE),
                                                 method=pipe.dlt).float())
    uv = np.random.default_rng(3).uniform(0, SIZE, (4, 5, 17, 2))
    flat = case["ref_rig"]._replace(distort=np.zeros((4, 5)))
    assert np.abs(ref.undistort_pixels(uv, flat) - uv).max() <= 1e-10


def _spans(pipe, frames):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe(frames)
    return {e.name for e in prof.events() if e.name.startswith("df3d.")}


def _fly_case(tmp_path):
    path = str(tmp_path / "fly.npz")
    synthetic.random_checkpoint(path, 5, 1, 8, 2, 19, (32, 64))
    calib = geometry.calib_to_arrays(synthetic.human_rig(num_cameras=7, k1=0.0), 7,
                                     dtype=np.float32)
    frames = np.random.default_rng(2).integers(0, 256, (1, 7, 480, 960, 3), dtype=np.uint8)
    return path, calib, frames


def test_undistort_span_opens_for_h36m_and_never_for_fly(case, small_frames, tmp_path):
    names = _spans(_pipe(case), case["frames"])
    assert {"df3d.undistort", "df3d.triangulate", "df3d.assemble", "df3d.net"} <= names
    path, calib, frames = _fly_case(tmp_path)
    fly = pipeline.build_pipeline(*reversed(load_weights(path)), calib, list(range(7)),
                                  rig=None, device="cpu")
    names = _spans(fly, frames)
    assert "df3d.triangulate" in names and "df3d.undistort" not in names


def test_fly_profile_named_is_the_default_bit_for_bit(tmp_path):
    path, calib, frames = _fly_case(tmp_path)
    variables, spec = load_weights(path)
    default = pipeline.build_pipeline(spec, variables, calib, list(range(7)), device="cpu")
    named = pipeline.build_pipeline(spec, variables, calib, list(range(7)), device="cpu",
                                    profile="fly")
    assert named.assemble and named.distort is None and named.dlt == "normal"
    assert named.flip.tolist() == [False] * 4 + [True] * 3
    for a, b in zip(default(frames), named(frames)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_an_unknown_profile_is_refused(tmp_path):
    path, calib, _ = _fly_case(tmp_path)
    with pytest.raises(ValueError, match="unknown profile 'mouse'"):
        pipeline.build_pipeline(*reversed(load_weights(path)), calib, list(range(7)),
                                device="cpu", profile="mouse")


def test_the_fly_template_is_refused_for_h36m(case):
    with pytest.raises(ValueError, match="7 cameras, the h36m profile 4"):
        pipeline.build_pipeline(*reversed(load_weights(case["path"])), case["calib"],
                                [0, 1, 2, 3], rig="auto", device="cpu", profile="h36m")


def test_the_dlt_is_the_profiles(case, monkeypatch):
    """The DLT and the geometry's dtype come from the profile's ``Config``:
    the fly's closed form in float32, the h36m's SVD in float64, and a
    profile that names the closed form gets it."""
    fly, h36m = pipeline.PROFILES["fly"](), h36m_config()
    assert (fly.dlt_method, fly.dlt_dtype) == ("normal", "float32")
    assert (h36m.dlt_method, h36m.dlt_dtype) == ("svd", "float64")
    monkeypatch.setitem(pipeline.PROFILES, "h36m", lambda: dataclasses.replace(
        h36m_config(), image_hw=(SIZE, SIZE), dlt_method="normal", dlt_dtype="float32"))
    pipe = _pipe(case)
    assert pipe.dlt == "normal" and pipe.R.dtype == pipe.distort.dtype == torch.float32


def test_triangulate_refuses_pixels_with_distort(case):
    R, tvec, intr, distort = (torch.from_numpy(a) for a in case["calib"])
    p2d = torch.full((4, 1, 17, 2), 0.5)
    pixels = geometry.rowcol_to_pixel_xy(p2d, (SIZE, SIZE))
    with pytest.raises(ValueError, match="pixels or distort, not both"):
        geometry.triangulate(p2d, R, tvec, intr, (SIZE, SIZE), distort=distort, pixels=pixels)
