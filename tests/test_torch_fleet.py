"""The port's multi-recording fleet driver vs the JAX package's, on the CPU.

Analogue of ``tests/test_fleet.py``: two copies of the bundled recording
(``num_images_max=2``), the conv checkpoint, ``solver="lm"``.  The port's
``process_recordings`` against JAX's: the same argmax cells (within 1e-6),
conf within 2e-5, and the calibration and 3D points at the ``lm``
tolerances (calibration 1e-4, points 1e-5).  Identical copies give
identical results; a two-entry CPU mesh gives what no mesh gives (points
within 1e-6, conf within 1e-5: one forward over 14 images against batches
of 8); a folder without images fails alone in both packages; ``save=True``
writes a result pickle with the JAX package's keys.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from deepfly3d_tpu.parallel import fleet as jax_fleet
from deepfly3d_torch.parallel import fleet, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "hourglass_fly.npz")
KW = dict(checkpoint=WEIGHTS, solver="lm", camera_ordering=list(range(7)))
CALIB_ATOL, PTS_ATOL = 1e-4, 1e-5


def _copies(root, names):
    folders = []
    for name in names:
        dst = root / name / "images"
        shutil.copytree(os.path.join(REPO, "tests", "data", "reference"), dst)
        folders.append(str(dst))
    return folders


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages over two copies each (their own folders, since each
    writes a result beside its input), the port also on a two-entry mesh."""
    root = tmp_path_factory.mktemp("fleet")
    port = fleet.process_recordings(_copies(root / "port", ("flyA", "flyB")), num_images_max=2,
                                    device="cpu", **KW)
    meshed = fleet.process_recordings(_copies(root / "mesh", ("flyA", "flyB")),
                                      num_images_max=2, device="cpu",
                                      mesh=mesh.data_mesh(devices=["cpu"] * 2), **KW)
    want = jax_fleet.process_recordings(_copies(root / "jax", ("flyA", "flyB")),
                                        num_images_max=2, **KW)
    return port, meshed, want


def test_fleet_matches_jax(runs):
    port, _, want = runs
    assert all(r.ok for r in port + want), [str(r.error) for r in port + want]
    for got, ref in zip(port, want):
        assert got.points2d.shape == ref.points2d.shape == (7, 2, 38, 2)
        np.testing.assert_allclose(got.points2d, ref.points2d, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.conf, ref.conf, atol=2e-5, rtol=0)
        for c in range(7):
            for k in ("R", "tvec"):
                np.testing.assert_allclose(got.calib[c][k], ref.calib[c][k], atol=CALIB_ATOL)
        assert got.points3d.shape == (2, 38, 3)
        np.testing.assert_allclose(got.points3d, ref.points3d, atol=PTS_ATOL)


def test_identical_copies_give_identical_results(runs):
    port, meshed, _ = runs
    for results in (port, meshed):
        np.testing.assert_array_equal(results[0].points2d, results[1].points2d)
        np.testing.assert_allclose(results[0].points3d, results[1].points3d, atol=1e-8)
        assert all(os.path.exists(r.save_path) for r in results)


def test_two_entry_mesh_equals_no_mesh(runs):
    port, meshed, _ = runs
    for a, b in zip(meshed, port):
        assert a.ok
        np.testing.assert_allclose(a.points2d, b.points2d, atol=1e-6, rtol=0)
        np.testing.assert_allclose(a.conf, b.conf, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.points3d, b.points3d, atol=PTS_ATOL)


def test_fleet_isolates_bad_recording(tmp_path):
    for name, run in (("port", lambda f: fleet.process_recordings(
                          f, num_images_max=1, save=False, device="cpu", **KW)),
                      ("jax", lambda f: jax_fleet.process_recordings(
                          f, num_images_max=1, save=False, **KW))):
        good = _copies(tmp_path / name, ("flyA",))[0]
        bad = str(tmp_path / name / "empty")
        os.makedirs(bad)
        results = run([good, bad])
        assert results[0].ok and results[0].save_path is None and results[0].points3d is None
        assert not results[1].ok and isinstance(results[1].error, FileNotFoundError)


def test_saved_pickle_has_the_jax_keys(runs):
    port, _, want = runs
    for got, ref in zip(port, want):
        with open(got.save_path, "rb") as f:
            mine = pickle.load(f)
        with open(ref.save_path, "rb") as f:
            theirs = pickle.load(f)
        assert sorted(map(str, mine)) == sorted(map(str, theirs))
        np.testing.assert_allclose(mine["points3d"], got.points3d)
