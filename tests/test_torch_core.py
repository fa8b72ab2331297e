"""The port's ``Core`` and ``cli`` over the bundled recording vs the JAX package.

* The golden contract through the port's ``Core`` at full width on the CPU
  (the conv checkpoint, rig registration on): points2d within 0.02 and
  confidences within 0.002 of ``df3d_result_2d.pkl`` (the reference's own
  bands).
* Seeded with golden 2D, the calibration chain (parity bundle adjustment,
  float64 SVD triangulation, Procrustes) gives ``points3d_wo_procrustes``
  and ``points3d`` within 1e-5 and every camera's calibration within 1e-4
  of ``df3d_result_3d.pkl``.
* A pickle written by either ``Core`` resumes in the other.
* ``get_points3d`` (Procrustes, normalization, One-Euro) equals the JAX
  ``Core``'s on the same seeded state within 1e-8.
* ``cli.main`` runs in-process with ``-n 3 --device cpu``; every flag of the
  JAX CLI parses and none raises NotImplementedError any more, and the
  default device raises without a card.
* The port's new modules import no jax (a clean subprocess).
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfly3d_tpu.core import Core as JaxCore
from deepfly3d_torch import cli
from deepfly3d_torch.core import Core, find_default_camera_ordering

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = [0, 1, 2, 3, 4, 5, 6]


def _core(folder, out=None, cls=Core, **kw):
    if cls is Core:
        kw.setdefault("device", "cpu")
    return cls(input_folder=folder, output_folder=out or folder + "_df3d", num_images_max=0,
               camera_ordering=ORDER, **kw)


def _seed(core, golden_2d):
    core.points2d = golden_2d["points2d"]
    core.conf = golden_2d["heatmap_confidence"]
    return core


def test_golden_contract_through_core(working_images, golden_2d):
    """Full width on the CPU: the conv checkpoint over the 105 golden JPEGs."""
    core = _core(working_images)
    assert core.num_images == 15 and core.image_shape == [960, 480]
    assert not core.streaming
    core.pose2d_estimation(batch_size=8)
    assert core.points2d.shape == (7, 15, 38, 2) and core.conf.shape == (7, 15, 19, 1)
    assert core.points2d.dtype == np.float64
    pts_err = np.abs(core.points2d - golden_2d["points2d"]).max()
    conf_err = np.abs(core.conf - golden_2d["heatmap_confidence"]).max()
    assert pts_err <= 0.02, pts_err
    assert conf_err <= 0.002, conf_err
    core.check_cameras()


def test_golden_calibration_chain(working_images, golden_2d, golden_3d):
    core = _seed(_core(working_images), golden_2d)
    result = core.calibrate_calc(0, 100)
    assert result.solver == "parity" and result.cost_final < result.cost_initial
    core.save()
    with open(core.save_path, "rb") as f:
        saved = pickle.load(f)
    np.testing.assert_allclose(saved["points3d_wo_procrustes"],
                               golden_3d["points3d_wo_procrustes"], atol=1e-5)
    np.testing.assert_allclose(saved["points3d"], golden_3d["points3d"], atol=1e-5)
    for cam in range(7):
        for key in saved[cam]:
            np.testing.assert_allclose(saved[cam][key], golden_3d[cam][key], atol=1e-4,
                                       err_msg=f"camera {cam} {key}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(working_images, golden_2d, writer):
    """Calibrate and save with one package's Core; the other resumes it."""
    w_cls, r_cls = (JaxCore, Core) if writer == "jax" else (Core, JaxCore)
    first = _seed(_core(working_images, cls=w_cls), golden_2d)
    first.calibrate_calc(0, 100)
    first.save()
    second = _core(working_images, cls=r_cls)
    assert second.save_path == first.save_path
    assert second.has_pose and second.has_calibration
    np.testing.assert_array_equal(second.points2d, first.points2d)
    np.testing.assert_array_equal(second.conf, first.conf)
    np.testing.assert_array_equal(second.points3d, first.points3d)
    for cam in range(7):
        for key in ("R", "tvec", "intr", "distort"):
            np.testing.assert_array_equal(second.calib[cam][key], first.calib[cam][key])
    # the resumed state triangulates to the saved raw points
    np.testing.assert_allclose(second.triangulate(), first._points3d_wo, atol=1e-9)


def test_get_points3d_matches_jax_core(working_images, golden_2d, golden_3d):
    """Same seeded state (golden 2D and golden calibration) in both Cores."""
    from deepfly3d_torch.io import result_schema

    calib = result_schema.extract_calib(golden_3d)
    cores = [_seed(_core(working_images, cls=cls), golden_2d) for cls in (Core, JaxCore)]
    for core in cores:
        core.calib = {c: dict(v) for c, v in calib.items()}
    port, ref = (core.get_points3d() for core in cores)
    assert port.shape == ref.shape == (15, 38, 3)
    np.testing.assert_allclose(port, ref, atol=1e-8, rtol=0)
    np.testing.assert_allclose(cores[0].reprojection_error(), cores[1].reprojection_error(),
                               rtol=1e-10)


def test_cli_main_in_process(working_images, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main([working_images, "-n", "3", "--device", "cpu",
                     "--output-folder", str(out)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("Saved results at") == 2 and "Reprojection error is" in printed
    files = os.listdir(out)
    result = [f for f in files if f.startswith("df3d_result_")]
    assert len(result) == 1
    with open(out / result[0], "rb") as f:
        saved = pickle.load(f)
    assert saved["points2d"].shape == (7, 3, 38, 2)
    assert saved["points3d"].shape == saved["points3d_wo_procrustes"].shape == (3, 38, 3)
    assert sorted(k for k in saved if isinstance(k, int)) == ORDER
    assert {"camera_ordering", "heatmap_confidence"} <= set(saved)


def test_cli_batch_modes(working_images, tmp_path):
    """--from-file and -r find the folders and isolate a failing one."""
    rec = tmp_path / "rec" / "images"
    shutil.copytree(working_images, rec)
    assert cli.find_subfolders(str(tmp_path), "images") == [str(rec)]
    listing = tmp_path / "list.txt"
    listing.write_text(f"{tmp_path / 'missing'}\n")
    assert cli.main([str(listing), "-f", "--device", "cpu"]) == 1
    empty = tmp_path / "empty" / "images"
    empty.mkdir(parents=True)
    # the only images/ folder holds no frames: its error is collected, not raised
    assert cli.main([str(tmp_path / "empty"), "-r", "--device", "cpu", "-n", "1"]) == 1


@pytest.mark.parametrize("flags", [["--video-2d"], ["--video-3d"], ["--solver", "lm"],
                                   ["--soft-argmax"], ["--profile", "h36m"]])
def test_unported_flags_raise(working_images, flags, capsys):
    """The flags that raised while their modules were not ported now parse
    and reach the run; none is refused up front any more (the videos run in
    tests/test_torch_viz.py, the h36m profile in tests/test_torch_h36m.py)."""
    args = cli.parse_cli_args([working_images, "--device", "cpu", *flags])
    attr = flags[0].lstrip("-").replace("-", "_")
    want = flags[1] if len(flags) > 1 else True
    assert getattr(args, attr) == want
    assert not hasattr(cli, "check_ported") and not hasattr(cli, "_NOT_PORTED")
    assert cli.main([working_images, "--device", "cpu", "--debug", *flags]) == 0
    assert f"{attr} = {want}" in capsys.readouterr().out


def test_default_device_raises_without_a_card(working_images, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([working_images, "-n", "1", "--output-folder", str(tmp_path / "o")])


def test_core_not_ported_methods_raise(working_images, golden_2d):
    """Every method of the JAX Core is ported: plot_2d draws what the JAX
    Core's draws, and the helpers beside it run."""
    port = _seed(_core(working_images), golden_2d)
    ref = _seed(_core(working_images, cls=JaxCore), golden_2d)
    np.testing.assert_array_equal(port.plot_2d(5, 2), ref.plot_2d(5, 2))
    core = _core(working_images)
    assert core.next_error(0) is None                     # no calibration yet
    with pytest.raises(AssertionError, match="Calibrate first"):
        core.solve_pictorial()


def test_camera_ordering(working_images):
    assert list(find_default_camera_ordering("/data/FA/exp1/images")) == [6, 5, 4, 3, 2, 1, 0]
    with pytest.raises(NotImplementedError):
        find_default_camera_ordering("/data/unknown/images")
    core = _core(working_images)
    assert not core.update_camera_ordering([0, 1, 2])
    assert core.update_camera_ordering([6, 5, 4, 3, 2, 1, 0])
    assert list(core.camera_ordering) == [6, 5, 4, 3, 2, 1, 0]


@pytest.mark.parametrize("threshold,streams", [(10, True), (100, False)])
def test_streaming_auto_policy(working_videos, threshold, streams):
    from deepfly3d_torch.config import fly_config

    cfg = fly_config()
    cfg.streaming_auto_threshold = threshold
    core = _core(working_videos, config=cfg)
    assert core.streaming == streams
    assert core.num_images == 15 and core.image_shape == [960, 480]
    assert any(f.endswith(".jpg") for f in os.listdir(working_videos)) != streams


def test_port_core_imports_no_jax():
    code = ("import sys, deepfly3d_torch.core, deepfly3d_torch.cli, deepfly3d_torch.io, "
            "deepfly3d_torch.io.discovery, deepfly3d_torch.io.native, "
            "deepfly3d_torch.io.posedb, deepfly3d_torch.io.result_schema, "
            "deepfly3d_torch.ops.bundle_adjust, deepfly3d_torch.ops.procrustes, "
            "deepfly3d_torch.ops.filters, deepfly3d_torch.utils.profiling, "
            "deepfly3d_torch.logger, deepfly3d_torch.skeletons, deepfly3d_torch.compat, "
            "deepfly3d_torch.gui_controller, deepfly3d_torch.ops.pictorial, "
            "deepfly3d_torch.models.decode, deepfly3d_torch.viz.video, "
            "deepfly3d_torch.viz.plot2d, deepfly3d_torch.viz.plot3d, "
            "deepfly3d_torch.viz.raster3d, deepfly3d_torch.skeletons.h36m, "
            "deepfly3d_torch.utils.synthetic, deepfly3d_torch.config; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.startswith('deepfly3d_tpu') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
