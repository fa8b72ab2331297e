"""The recording path's remaining options in the port vs the JAX package.

* 2D filters: ``filter_batch_2d``, the stateful ``OneEuroFilter`` and
  ``smooth_pose2d`` against JAX's within 1e-12 (float64 host code).
* ``Core``'s correction helpers (points in pixels, manual corrections through
  the pose database, nearest joint, error navigation, frames, the memoised
  smoother) against the JAX ``Core``'s on the same seeded state; ``compat``
  (``CameraNetwork``) and ``GuiController`` as analogues of
  ``tests/test_compat.py`` and ``tests/test_gui_controller.py``.
* What still raises names an item of ROADMAP.md's Queue 1 that is about it.
* ``cli.main`` with ``--soft-argmax --solver lm --ba-huber-px 5`` on the CPU.
* At full width, ``deepfly3d_torch/data/options_t15.npz`` holds the JAX
  package's results that the chip smoke run's core phase checks the card
  against: ``Core.pose2d_estimation`` with and without ``soft_argmax`` on the
  bundled recording (conv checkpoint, rig registration on), the ``lm``
  calibration chain seeded with golden 2D (plain, with ``huber_px=5`` and
  with ``huber_px=5`` cut to 12 iterations) and ``Core.solve_pictorial`` on
  frames 0-1 seeded with golden 2D and calibration.  The port on the CPU
  must match them at the card's tolerances.  Regenerate it with

      python tests/test_torch_options.py --write
"""

import os
import pickle
import re
import shutil
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

import torch  # noqa: E402

from deepfly3d_tpu import compat as jax_compat  # noqa: E402
from deepfly3d_tpu.core import Core as JaxCore  # noqa: E402
from deepfly3d_tpu.ops import filters as jax_filters  # noqa: E402
from deepfly3d_torch import cli, compat  # noqa: E402
from deepfly3d_torch.core import Core  # noqa: E402
from deepfly3d_torch.gui_controller import GuiController  # noqa: E402
from deepfly3d_torch.io import result_schema  # noqa: E402
from deepfly3d_torch.ops import filters  # noqa: E402

REFERENCE = os.path.join(REPO, "tests", "data", "reference")
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "reference_df3d")
OPTIONS_REF = os.path.join(REPO, "deepfly3d_torch", "data", "options_t15.npz")
ORDER = list(range(7))
HM_HW = (64, 128)
# the card's tolerances against JAX (chip_smoke.py's core phase)
CONF_ATOL, SOFT_ATOL, CONF_MIN, CALIB_ATOL, PTS3D_ATOL, PIC_ATOL = \
    2e-5, 1e-4, 0.1, 1e-4, 1e-5, 1e-3
LM_RUNS = {"lm": {}, "hub": {"huber_px": 5.0}, "hub12": {"huber_px": 5.0, "max_iters": 12}}


def _core(folder, cls=Core, out=None, n=0, **kw):
    if cls is Core:
        kw.setdefault("device", "cpu")
    return cls(input_folder=folder, output_folder=out or folder + "_df3d", num_images_max=n,
               camera_ordering=ORDER, **kw)


def _seeded(folder, golden_2d, golden_3d=None, cls=Core, out=None, frames=None, **kw):
    core = _core(folder, cls, out, n=frames or 0, **kw)
    sl = slice(None) if frames is None else slice(0, frames)
    core.points2d = np.array(golden_2d["points2d"][:, sl])
    core.conf = np.array(golden_2d["heatmap_confidence"][:, sl])
    if golden_3d is not None:
        core.calib = result_schema.extract_calib(golden_3d)
    return core


def conf38(conf, order):
    """(C, T, 19, 1) per-camera confidences -> (C, T, 38) on the assembled
    joints (0 where the assembly keeps none of the camera's predictions)."""
    C, T, K, _ = conf.shape
    out = np.zeros((C, T, 2 * K))
    for pos, cam in enumerate(order):
        if pos != 3:
            side = slice(0, K) if pos < 3 else slice(K, 2 * K)
            out[cam, :, side] = conf[cam, ..., 0]
    return out


# ---------------------------------------------------------------- filters


def test_filter_batch_2d_matches_jax():
    rng = np.random.default_rng(0)
    pts = np.cumsum(rng.normal(size=(40, 38, 2)) * 4.0, axis=0) + [480.0, 240.0]
    np.testing.assert_allclose(filters.filter_batch_2d(pts), jax_filters.filter_batch_2d(pts),
                               atol=1e-12, rtol=0)
    for kw in ({"filter_indices": [0, 5, 37]}, {"freq": 30.0},
               {"config_oneeuro": {"freq": 50.0, "mincutoff": 0.5, "beta": 1.0,
                                   "dcutoff": 2.0}}):
        np.testing.assert_allclose(filters.filter_batch_2d(pts, **kw),
                                   jax_filters.filter_batch_2d(pts, **kw), atol=1e-12, rtol=0)
    out = filters.filter_batch_2d(pts, filter_indices=[1])
    np.testing.assert_array_equal(out[:, 2:], pts[:, 2:])
    np.testing.assert_array_equal(out[0], pts[0])        # the first sample passes through


def test_one_euro_filter_objects_match_jax():
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.normal(size=60)) * 10
    ts = np.arange(1, 61) * 0.1
    for args in ((100.0, 0.1, 2.0, 1.0), (30.0, 1.0, 0.0, 1.0)):
        f, g = filters.OneEuroFilter(*args), jax_filters.OneEuroFilter(*args)
        got = np.array([f(v, t) for v, t in zip(x, ts)])
        want = np.array([g(v, t) for v, t in zip(x, ts)])
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    # the stateful filter is the batch recursion, sample for sample
    f = filters.OneEuroFilter(100.0, 0.1, 2.0, 1.0)
    batch = filters.filter_batch(np.repeat(x[:, None, None], 3, axis=2))[:, 0, 0]
    np.testing.assert_allclose([f(v, t) for v, t in zip(x, ts)], batch, atol=1e-12, rtol=0)
    with pytest.raises(ValueError):
        filters.LowPassFilter(0.0)
    with pytest.raises(ValueError):
        filters.OneEuroFilter(0.0)
    lp = filters.LowPassFilter(0.5)
    assert lp.lastValue() is None and lp(2.0) == 2.0 and lp(4.0) == 3.0 and lp.lastValue() == 4.0


def test_smooth_pose2d_matches_jax_and_the_scipy_loop():
    from scipy.ndimage import gaussian_filter1d

    rng = np.random.default_rng(3)
    T, J = 25, 4
    pts = rng.normal(size=(T, J, 2))
    pts[:, -1] += np.linspace(0, 300, T)[:, None]          # one jumpy joint: kept raw
    got = filters.smooth_pose2d(pts)
    np.testing.assert_allclose(got, jax_filters.smooth_pose2d(pts), atol=1e-12, rtol=0)
    window, pad = 20, 20
    padded = np.concatenate([np.repeat(pts[:1], pad, 0), pts, np.repeat(pts[-1:], pad, 0)])
    want = pts.copy()
    for t in range(pad, T + pad):
        for j in range(J):
            for d in range(2):
                seg = padded[t - window // 2:t + window // 2, j, d]
                sigma = 7 if np.std(seg) < 5 else 0.1
                want[t - pad, j, d] = gaussian_filter1d(seg, sigma=sigma,
                                                        mode="nearest")[window // 2]
    np.testing.assert_allclose(got, want, atol=1e-10)
    for kw in ({"window_size": 10, "pad": 8}, {"std_thr": 0.5, "sigma_smooth": 3.0}):
        np.testing.assert_allclose(filters.smooth_pose2d(pts, **kw),
                                   jax_filters.smooth_pose2d(pts, **kw), atol=1e-12, rtol=0)


# ------------------------------------------------------ Core's helpers


def test_corrections_match_jax_core(working_images, golden_2d):
    cores = [_seeded(working_images, golden_2d, cls=cls, out=working_images + f"_{i}")
             for i, cls in enumerate((Core, JaxCore))]
    for core in cores:
        np.testing.assert_array_equal(core.points2d_pixels_xy(2, 4)[:, 0],
                                      golden_2d["points2d"][2, 4, :, 1] * 960)
        before = core.corrected_points2d(0, 0).copy()
        core.move_joint(0, 0, 2, before[2, 0] + 100, before[2, 1] + 100)  # persisted
        x, y = core.corrected_points2d(1, 3)[7]
        core.move_joint(1, 3, 7, x + 5, y)                                 # under 30 px
        core.move_joint(5, 2, 25, 300.0, 200.0)
        assert np.abs(core.corrected_points2d(0, 0)[2] - before[2]).max() > 90
        assert core.db.read(1, 3) is None
    port, ref = cores
    for cam, img in ((0, 0), (5, 2), (1, 3), (3, 9)):
        np.testing.assert_array_equal(port.corrected_points2d(cam, img),
                                      ref.corrected_points2d(cam, img))
    np.testing.assert_array_equal(port.corrected_points2d_matrix(),
                                  ref.corrected_points2d_matrix())
    assert port.db.read_modified_joints(0, 0) == ref.db.read_modified_joints(0, 0) == [2]
    # moving it back under the threshold erases the correction
    port.move_joint(0, 0, 2, *port.points2d_pixels_xy(0, 0)[2])
    assert port.db.read(0, 0) is None
    port.save_corrections()
    assert any(f.startswith("pose_corr") for f in os.listdir(port.output_folder))


def test_nearest_joint_matches_jax_core(working_images, golden_2d):
    port, ref = (_seeded(working_images, golden_2d, cls=cls, out=working_images + f"_{i}")
                 for i, cls in enumerate((Core, JaxCore)))
    pts = port.points2d_pixels_xy(0, 0)
    assert port.nearest_joint(0, 0, *pts[5]) == 5
    assert port.nearest_joint(0, 0, 0, 0) < 19           # camera 0 sees no right-side joint
    rng = np.random.default_rng(0)
    for cam in range(7):
        for x, y in rng.uniform([0, 0], [960, 480], size=(6, 2)):
            assert port.nearest_joint(cam, 1, x, y) == ref.nearest_joint(cam, 1, x, y)


def test_error_navigation_matches_jax_core(working_images, golden_2d, golden_3d):
    port, ref = (_seeded(working_images, golden_2d, golden_3d, cls=cls,
                         out=working_images + f"_{i}")
                 for i, cls in enumerate((Core, JaxCore)))
    # a planted outlier: camera 1 sees joint 3 of frame 6 200 px off
    for core in (port, ref):
        core.points2d[1, 6, 3] += [200 / 480, 0.0]
        core._invalidate_downstream()
    errors = port._joint_reprojection_errors()
    assert errors.shape == (15, 38)
    np.testing.assert_allclose(errors, ref._joint_reprojection_errors(), rtol=1e-9, atol=1e-9)
    for img in range(15):
        assert port.next_error(img) == ref.next_error(img)
        assert port.prev_error(img) == ref.prev_error(img)
    flagged = [t for t in range(15) if (errors[t] > port.config.reproj_thr_px).any()]
    assert 6 in flagged and errors[6, 3] > 100
    assert port.next_error(5) == min(t for t in flagged if t > 5)
    assert port.joint_has_error(6, 3) and not port.joint_has_error(5, 3)
    port.calib = None
    assert port.next_error(0) is None


def test_get_image_and_smooth_points2d(working_images, golden_2d):
    from deepfly3d_torch.io import discovery

    port, ref = (_seeded(working_images, golden_2d, cls=cls, out=working_images + f"_{i}")
                 for i, cls in enumerate((Core, JaxCore)))
    img = port.get_image(3, 7)
    assert img.shape == (480, 960, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, discovery.read_image(
        os.path.join(working_images, "camera_3_img_7.jpg")))
    smooth = port.smooth_points2d(2)
    assert smooth.shape == (15, 38, 2)
    np.testing.assert_allclose(smooth, ref.smooth_points2d(2), atol=1e-12, rtol=0)
    assert port.smooth_points2d(2) is smooth                 # memoised
    port.points2d = port.points2d * 0.5
    port._invalidate_downstream()
    assert port.smooth_points2d(2) is not smooth


def test_get_image_from_a_streamed_recording(working_videos):
    core = _core(working_videos, streaming=True)
    assert core.streaming
    frame = core.get_image(0, 4)
    assert frame.shape == (480, 960, 3) and frame.dtype == np.uint8


# ------------------------------------------------------------- compat


@pytest.fixture(scope="module")
def cam_nets(golden_3d_module):
    pts = golden_3d_module["points2d"] * [480, 960]          # reference scaling (core.py:247)
    return (compat.CameraNetwork(pts, calib=golden_3d_module),
            jax_compat.CameraNetwork(pts, calib=golden_3d_module))


def test_compat_triangulation_matches_jax(cam_nets, golden_3d):
    port, ref = cam_nets
    assert port.has_calibration() and set(port.summarize()) == set(range(7))
    pts3d = port.triangulate()
    np.testing.assert_allclose(pts3d, golden_3d["points3d_wo_procrustes"], atol=1e-5)
    np.testing.assert_allclose(pts3d, ref.triangulate(), atol=1e-9, rtol=0)
    err = port.reprojection_error()
    assert 0.5 < err < 10.0
    np.testing.assert_allclose(err, ref.reprojection_error(), rtol=1e-10)


def test_compat_bundle_adjust_and_accessors(cam_nets, golden_2d, golden_3d, calib_prior):
    net = compat.CameraNetwork(golden_2d["points2d"] * [480, 960],
                               calib={int(k): v for k, v in calib_prior.items()
                                      if isinstance(k, (int, np.integer))},
                               image_path=os.path.join(REFERENCE, "camera_{cam_id}_img_{img_id}.jpg"))
    cost = net.bundle_adjust()
    assert cost > 0
    for c in range(7):
        np.testing.assert_allclose(net.calib[c]["R"], golden_3d[c]["R"], atol=1e-4)
        np.testing.assert_allclose(net.calib[c]["tvec"], golden_3d[c]["tvec"], atol=1e-4)
    cam = cam_nets[0][0]
    assert cam.points2d.shape == (15, 38, 2) and cam[0].shape == (38, 2)
    assert not cam.is_empty() and cam_nets[0][3].is_empty()
    assert net[2].get_image(1).shape == (480, 960, 3)
    assert compat.df3d_bones.shape[1] == 2 and compat.df3d_colors.shape == (38, 3)
    np.testing.assert_array_equal(compat.df3d_bones, jax_compat.df3d_bones)
    ref = jax_compat.CameraNetwork(golden_2d["points2d"] * [480, 960],
                                   image_path=os.path.join(REFERENCE,
                                                           "camera_{cam_id}_img_{img_id}.jpg"))
    drawn = net[2].plot_2d(1)
    np.testing.assert_array_equal(drawn, ref[2].plot_2d(1))
    assert (drawn != net[2].get_image(1)).any()


def test_procrustes_seperate_reference_spelling(golden_3d):
    out = compat.procrustes_seperate(np.asarray(golden_3d["points3d_wo_procrustes"]))
    np.testing.assert_allclose(out, golden_3d["points3d"], atol=1e-5)


# -------------------------------------------------------- GuiController


@pytest.fixture()
def ctl(working_images, golden_2d, golden_3d):
    return GuiController(_seeded(working_images, golden_2d, golden_3d))


def test_gui_navigation(ctl):
    assert ctl.img_id == 0
    ctl.prev_image()
    assert ctl.img_id == 0
    ctl.next_image()
    assert ctl.img_id == 1
    ctl.last_image()
    assert ctl.img_id == ctl.core.max_img_id
    ctl.next_image()
    assert ctl.img_id == ctl.core.max_img_id
    ctl.first_image()
    assert ctl.img_id == 0
    assert ctl.goto("3") == (True, None) and ctl.img_id == 3
    ok, msg = ctl.goto("not-a-number")
    assert not ok and "image id" in msg and ctl.img_id == 3
    assert not ctl.goto("99999")[0] and ctl.img_id == 3


def test_gui_modes_and_render(ctl, working_images):
    fresh = GuiController(_core(working_images, out=working_images + "_fresh"))
    assert not fresh.set_mode("pose") and not fresh.set_mode("correction")
    assert fresh.mode == "image" and not fresh.joint_filter_enabled
    assert ctl.set_mode("pose") and ctl.joint_filter_enabled
    pose = ctl.render(0)                                    # the overlay of viz/plot2d.py
    assert pose.shape == (480, 960, 3) and (pose != ctl.core.get_image(0, ctl.img_id)).any()
    np.testing.assert_array_equal(pose, ctl.core.plot_2d(0, ctl.img_id, joints=ctl.joint_filter))
    assert ctl.set_mode("correction") and ctl.set_mode("image")
    assert not ctl.joint_filter_enabled
    assert ctl.render(0).shape == (480, 960, 3)


def test_gui_correction_flow(ctl):
    ctl.set_mode("pose")
    assert not ctl.press(0, 10, 10, 960, 480)
    ctl.set_mode("correction")
    x, y = ctl.core.points2d_pixels_xy(0, 0)[2]
    assert ctl.press(0, x, y, 960, 480) and ctl.joint_being_dragged == 2
    assert ctl.drag(0, x + 120, y + 60, 960, 480)
    assert ctl.core.db.read(0, 0) is not None
    assert abs(ctl.core.corrected_points2d(0, 0)[2, 0] - (x + 120)) < 2
    assert ctl.release() and not ctl.release()
    assert ctl.press(0, x + 120, y + 60, 960, 480) and ctl.joint_being_dragged == 2
    ctl.drag(0, x, y, 960, 480)
    assert ctl.core.db.read(0, 0) is None
    assert ctl.view_to_pixels(100, 50, 480, 240) == (200.0, 100.0)


def test_gui_actions_and_keys(ctl):
    ok, msg = ctl.next_error()
    assert (ok and ctl.img_id > 0 and msg is None) or "next images" in msg
    ctl.last_image()
    ok, msg = ctl.next_error()
    assert not ok and "next images" in msg
    ctl.save()
    assert os.path.exists(ctl.core.save_path)
    ctl.goto("2")
    assert ctl.handle_key("a") and ctl.img_id == 1
    assert ctl.handle_key("D") and ctl.img_id == 2
    assert ctl.handle_key("X") and ctl.mode == "pose"
    assert ctl.handle_key("C") and ctl.mode == "correction"
    assert ctl.handle_key("I") and ctl.mode == "image"
    assert ctl.handle_key("T") and not ctl.handle_key("Q")
    ctl.core.calib = None
    ok, msg = ctl.auto_correct()
    assert not ok and "calibration" in msg


# ------------------------------------------------ what still raises


def _queue1_items():
    """ROADMAP.md Queue 1: {item number: its text}."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    queue = text.split("### Queue 1")[1].split("\n### ")[0]
    return {int(m.group(1)): m.group(2)
            for m in re.finditer(r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", queue, re.M | re.S)}


def _named_item(message):
    m = re.search(r"ROADMAP\.md Queue 1 item (\d+)", message)
    assert m, message
    return int(m.group(1))


def test_not_ported_messages_name_current_roadmap_items(working_images, golden_2d):
    """What still raises names a Queue 1 item, and the item is about it.
    Since the video flags, ``plot_2d`` and the h36m profile are ported, that
    is the ``eigh`` triangulation alone."""
    items = _queue1_items()
    assert items
    assert not hasattr(cli, "_NOT_PORTED")
    assert _seeded(working_images, golden_2d).plot_2d(0, 0).shape == (480, 960, 3)
    from deepfly3d_torch.config import h36m_config
    from deepfly3d_torch.ops import geometry

    assert h36m_config().num_cameras == 4
    for call, keyword in ((lambda: geometry.triangulate(
                              torch.zeros(7, 1, 38, 2), torch.zeros(7, 3, 3), torch.zeros(7, 3),
                              torch.zeros(7, 3, 3), (960, 480), method="eigh"), "eigh"),):
        with pytest.raises(NotImplementedError) as e:
            call()
        assert keyword in items[_named_item(str(e.value))]


# ---------------------------------------------------------------- CLI


def test_cli_with_the_new_options(working_images, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main([working_images, "-n", "3", "--soft-argmax", "--solver", "lm",
                     "--ba-huber-px", "5", "--device", "cpu", "--output-folder", str(out)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("Saved results at") == 2 and "Reprojection error is" in printed
    result = [f for f in os.listdir(out) if f.startswith("df3d_result_")]
    with open(out / result[0], "rb") as f:
        saved = pickle.load(f)
    assert saved["points2d"].shape == (7, 3, 38, 2)
    assert np.isfinite(saved["points3d"]).all() and saved["points3d"].shape == (3, 38, 3)
    with np.load(OPTIONS_REF) as z:
        ref = {k: z[k] for k in z.files}
    # the first 3 frames of the full-width soft-argmax run (per-image results)
    np.testing.assert_allclose(saved["heatmap_confidence"], ref["soft_conf"][:, :3],
                               atol=CONF_ATOL, rtol=0)
    sure = conf38(ref["soft_conf"][:, :3], ORDER) >= CONF_MIN
    np.testing.assert_allclose(saved["points2d"][sure], ref["soft_p38"][:, :3][sure],
                               atol=SOFT_ATOL, rtol=0)
    assert not np.array_equal(saved["points2d"], ref["hard_p38"][:, :3])
    args = cli.parse_cli_args([working_images, "--solver", "lm", "--ba-huber-px", "5"])
    assert cli._solver_kwargs(args) == {"huber_px": 5.0}
    args = cli.parse_cli_args([working_images, "--ba-huber-px", "5"])
    assert cli._solver_kwargs(args) == {}                  # the parity solver takes none


# ---------------------------------------- the card's JAX reference, full width


@pytest.fixture(scope="module")
def options_ref():
    with np.load(OPTIONS_REF) as z:
        return {k: z[k] for k in z.files}


def test_soft_argmax_core_matches_the_reference(working_images, options_ref):
    """Core.pose2d_estimation(soft_argmax=True) over the 105 golden JPEGs."""
    ref = options_ref
    core = _core(working_images)
    core.pose2d_estimation(batch_size=8, soft_argmax=True)
    p38, conf = core.points2d, core.conf
    np.testing.assert_allclose(conf, ref["soft_conf"], atol=CONF_ATOL, rtol=0)
    # within half a heatmap cell of JAX's argmax points (the same cells)
    cells = np.abs(p38 - ref["hard_p38"]) * HM_HW
    assert cells.max() <= 0.5 + 1e-4, cells.max()
    sure = conf38(conf, ORDER) >= CONF_MIN
    assert sure.sum() > 1000
    np.testing.assert_allclose(p38[sure], ref["soft_p38"][sure], atol=SOFT_ATOL, rtol=0)


@pytest.mark.parametrize("run", list(LM_RUNS))
def test_lm_chain_matches_the_reference(working_images, golden_2d, options_ref, run):
    core = _seeded(working_images, golden_2d)
    result = core.calibrate_calc(0, 100, solver="lm", **LM_RUNS[run])
    core.save()
    with open(core.save_path, "rb") as f:
        saved = pickle.load(f)
    ref = options_ref
    np.testing.assert_allclose(result.cost_final, ref[f"{run}_cost"], rtol=1e-6)
    if run == "hub":            # 30 Huber iterations follow the round-off (ROADMAP Queue 3)
        return
    np.testing.assert_allclose(np.stack([saved[c]["R"] for c in ORDER]), ref[f"{run}_R"],
                               atol=CALIB_ATOL, rtol=0)
    np.testing.assert_allclose(np.stack([saved[c]["tvec"] for c in ORDER]), ref[f"{run}_tvec"],
                               atol=CALIB_ATOL, rtol=0)
    for key in ("points3d_wo_procrustes", "points3d"):
        np.testing.assert_allclose(saved[key], ref[f"{run}_{key}"], atol=PTS3D_ATOL, rtol=0)


def test_solve_pictorial_matches_the_reference(working_images, golden_2d, golden_3d,
                                               options_ref):
    core = _seeded(working_images, golden_2d, golden_3d, frames=2)
    out = core.solve_pictorial(apply=True)
    np.testing.assert_allclose(core.points2d, options_ref["pic_p2"], atol=PIC_ATOL, rtol=0)
    for side in ("left", "right"):
        np.testing.assert_allclose(out[side], options_ref[f"pic_{side}"], atol=PIC_ATOL, rtol=0)


def write_reference():
    """Run the JAX package's Core on the bundled recording and write OPTIONS_REF."""
    def load(name):
        with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
            return pickle.load(f)

    golden_2d, golden_3d = load("df3d_result_2d.pkl"), load("df3d_result_3d.pkl")
    tmp = tempfile.mkdtemp()
    try:
        rec = os.path.join(tmp, "reference")
        os.makedirs(rec)
        for name in os.listdir(REFERENCE):
            if name.endswith(".jpg"):
                shutil.copy(os.path.join(REFERENCE, name), rec)
        out = {}
        for key, soft in (("soft", True), ("hard", False)):
            core = _core(rec, JaxCore, out=os.path.join(tmp, key))
            core.pose2d_estimation(batch_size=8, soft_argmax=soft)
            out[f"{key}_p38"], out[f"{key}_conf"] = core.points2d, core.conf
        for run, kw in LM_RUNS.items():
            core = _seeded(rec, golden_2d, cls=JaxCore, out=os.path.join(tmp, run))
            out[f"{run}_cost"] = np.float64(core.calibrate_calc(0, 100, solver="lm",
                                                                **kw).cost_final)
            core.save()
            with open(core.save_path, "rb") as f:
                saved = pickle.load(f)
            out[f"{run}_R"] = np.stack([saved[c]["R"] for c in ORDER])
            out[f"{run}_tvec"] = np.stack([saved[c]["tvec"] for c in ORDER])
            for k in ("points3d_wo_procrustes", "points3d"):
                out[f"{run}_{k}"] = saved[k]
        core = _seeded(rec, golden_2d, golden_3d, cls=JaxCore, out=os.path.join(tmp, "pic"),
                       frames=2)
        pic = core.solve_pictorial(apply=True)
        out["pic_p2"] = core.points2d
        out["pic_left"], out["pic_right"] = pic["left"], pic["right"]
        np.savez_compressed(OPTIONS_REF, **out)
        print(f"wrote {OPTIONS_REF}: {sorted(out)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_reference()
