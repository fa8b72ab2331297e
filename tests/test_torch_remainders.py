"""The last pieces of modules the port already has, vs the JAX package's.

* ``geometry.triangulate(method="eigh")`` (the eigenvector of A^T A with the
  smallest eigenvalue) on the golden 2D in float64: within 1e-12 of JAX's
  (measured 6.1e-14 at magnitudes ~4: both square A's condition number, the
  LAPACK calls differ) and within the golden 1e-5 of
  ``points3d_wo_procrustes``; the default method is JAX's ``"svd"``.
* ``canonicalize.build_template`` / ``save_template`` on 2 frames of every
  camera of ``tests/data/reference``: arrays equal to JAX's, and the saved
  file loads in both packages to the same arrays.
* ``profiling.trace_to`` writes a trace file on the CPU.
"""

import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfly3d_tpu.ops import canonicalize as jax_canon
from deepfly3d_tpu.ops import geometry as jax_geo
from deepfly3d_torch.io import discovery
from deepfly3d_torch.ops import canonicalize, geometry
from deepfly3d_torch.utils.profiling import trace_to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "data", "reference")


def _golden_arrays(golden_3d):
    R, tvec, intr, _ = jax_geo.calib_to_arrays({c: golden_3d[c] for c in range(7)}, 7)
    return golden_3d["points2d"], R, tvec, intr


def test_triangulate_eigh_matches_jax_and_golden(golden_3d):
    p2, R, tvec, intr = _golden_arrays(golden_3d)
    want = np.asarray(jax_geo.triangulate(*(jnp.asarray(a) for a in (p2, R, tvec, intr)),
                                          (960, 480), method="eigh"))
    args = [torch.from_numpy(a) for a in (p2, R, tvec, intr)]
    got = geometry.triangulate(*args, (960, 480), method="eigh").numpy()
    assert got.dtype == np.float64 and got.shape == (15, 38, 3)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got, golden_3d["points3d_wo_procrustes"], atol=1e-5)
    # joints seen by fewer than two cameras are zeros, as with "svd"
    seen = geometry.observation_mask(args[0]).sum(0).numpy() >= 2
    np.testing.assert_array_equal(got[~seen], 0.0)


def test_triangulate_defaults_to_svd_as_jax(golden_3d):
    args = [torch.from_numpy(a) for a in _golden_arrays(golden_3d)]
    np.testing.assert_array_equal(geometry.triangulate(*args, (960, 480)).numpy(),
                                  geometry.triangulate(*args, (960, 480), method="svd").numpy())
    default = [inspect.signature(f).parameters["method"].default
               for f in (geometry.triangulate, jax_geo.triangulate)]
    assert default == ["svd", "svd"]


@pytest.fixture(scope="module")
def calibration_frames():
    """(C, T, H, W, 3) uint8: 2 frames of each camera of the bundled recording."""
    return np.stack([np.stack([discovery.read_image(
        os.path.join(REFERENCE, f"camera_{c}_img_{t}.jpg")) for t in range(2)])
        for c in range(7)])


def test_build_and_save_template_match_jax(calibration_frames, tmp_path):
    got = canonicalize.build_template(calibration_frames)
    want = jax_canon.build_template(calibration_frames)
    for field in ("row_profile", "col_profile", "mean"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got.image_hw == want.image_hw == (480, 960)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    canonicalize.save_template(port_file, got, source="2 frames of tests/data/reference")
    jax_canon.save_template(jax_file, want, source="2 frames of tests/data/reference")
    with np.load(port_file) as p, np.load(jax_file) as j:
        assert sorted(p.files) == sorted(j.files)
        assert str(p["source"]) == str(j["source"])
    for loaded in (canonicalize.load_template(port_file), jax_canon.load_template(port_file),
                   canonicalize.load_template(jax_file)):
        for field in ("row_profile", "col_profile", "mean"):
            np.testing.assert_array_equal(getattr(loaded, field), getattr(want, field))


def test_trace_to_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace_to(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        trace = json.load(f)
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
