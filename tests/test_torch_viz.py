"""``viz/``, ``Core.plot_2d`` and the video flags in the port vs the JAX package.

Host code in numpy, cv2 and matplotlib, copied call for call, so every
comparison is exact (pixel-equal uint8):

* ``draw_pose2d`` (every marker style, a joint subset), ``render_frame_3d_fast``
  and ``render_frame_3d`` against JAX's on golden frames and points (fly) and
  on a seeded human scene (h36m skeleton);
* ``Core.plot_2d`` with raw, smoothed and corrected points against the JAX
  ``Core``'s on the same seeded state;
* both videos of the bundled recording's first frames, rendered by the port
  from the golden result as ``scripts/make_video_goldens.py`` renders them,
  frame for frame equal to ``tests/data/golden_videos/`` (decoded as
  ``tests/test_cli_video.py::TestVideoPixelGolden`` decodes them);
* ``cli.main --skip-pose-estimation --video-2d --video-3d`` on the CPU;
* the matplotlib 3D row fanned out over spawned worker processes, against JAX's;
* ``GuiController``'s pose and correction views against the JAX controller's.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from deepfly3d_tpu.core import Core as JaxCore
from deepfly3d_tpu.gui_controller import GuiController as JaxGuiController
from deepfly3d_tpu.skeletons import fly as jax_fly
from deepfly3d_tpu.skeletons import h36m as jax_h36m
from deepfly3d_tpu.viz import plot2d as jax_plot2d
from deepfly3d_tpu.viz import plot3d as jax_plot3d
from deepfly3d_tpu.viz import raster3d as jax_raster3d
from deepfly3d_tpu.viz import video as jax_video
from deepfly3d_torch import cli
from deepfly3d_torch.core import Core
from deepfly3d_torch.gui_controller import GuiController
from deepfly3d_torch.io import discovery, result_schema
from deepfly3d_torch.skeletons import fly, h36m
from deepfly3d_torch.utils import synthetic
from deepfly3d_torch.viz import plot2d, plot3d, raster3d, video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "data", "reference")
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "reference_df3d")
GOLDEN_VIDEOS = os.path.join(REPO, "tests", "data", "golden_videos")
ORDER = list(range(7))
NUM_FRAMES, FPS = 4, 5          # scripts/make_video_goldens.py


def _golden_3d():
    with open(os.path.join(GOLDEN_DIR, "df3d_result_3d.pkl"), "rb") as f:
        return pickle.load(f)


def _seed_result(working, golden):
    """The golden result as ``working``'s result pickle (make_video_goldens.py)."""
    out_dir = working + "_df3d"
    os.makedirs(out_dir, exist_ok=True)
    result_schema.save_result(
        result_schema.result_path(out_dir, working),
        points2d=golden["points2d"], camera_ordering=golden["camera_ordering"],
        heatmap_confidence=golden["heatmap_confidence"],
        calib=result_schema.extract_calib(golden), points3d=golden["points3d"],
        points3d_wo_procrustes=golden["points3d_wo_procrustes"])
    return out_dir


def _read_frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def _video_name(kind, folder):
    return f"video_pose{kind}_" + folder.replace("/", "_") + ".mp4"


# ------------------------------------------------------------- drawing


@pytest.mark.parametrize("cam,img,kw", [
    (0, 0, {}), (1, 7, {}), (5, 14, {"joints": (0, 1, 2, 3, 4, 19, 20)}),
    (6, 2, {"marker": "square"}), (2, 9, {"marker_color": None, "scatter_r": 4,
                                          "line_thickness": 2}),
])
def test_draw_pose2d_matches_jax(golden_2d, cam, img, kw):
    image = discovery.read_image(os.path.join(REFERENCE, f"camera_{cam}_img_{img}.jpg"))
    pts = np.stack([golden_2d["points2d"][cam, img, :, 1] * 960,
                    golden_2d["points2d"][cam, img, :, 0] * 480], axis=-1)
    got = plot2d.draw_pose2d(image, pts, fly.skeleton, cam_id=cam, **kw)
    want = jax_plot2d.draw_pose2d(image, pts, jax_fly.skeleton, cam_id=cam, **kw)
    assert got.shape == image.shape and (got != image).any()
    np.testing.assert_array_equal(got, want)
    assert plot2d.MARKER_COLOR == jax_plot2d.MARKER_COLOR
    for pt in ((0.0, 0.0), (959.7, 0.0), (10.0, 481.5), (500.0, 200.0)):
        assert plot2d._valid_point(np.asarray(pt), 960, 480) == \
            jax_plot2d._valid_point(np.asarray(pt), 960, 480)


def _human_points():
    _, points3d, pixels = synthetic.human_frames(3, 2, synthetic.human_rig(), size=200)
    return points3d, pixels


def test_draw_pose2d_h36m_matches_jax():
    points3d, pixels = _human_points()
    image = np.random.default_rng(0).integers(0, 255, (1000, 1000, 3), dtype=np.uint8)
    for cam in range(4):
        got = plot2d.draw_pose2d(image, pixels[cam, 0], h36m.skeleton, cam_id=cam)
        np.testing.assert_array_equal(
            got, jax_plot2d.draw_pose2d(image, pixels[cam, 0], jax_h36m.skeleton, cam_id=cam))


def test_render_frame_3d_fast_matches_jax():
    golden = _golden_3d()
    for img in (0, 11):
        for cam in range(7):
            got = raster3d.render_frame_3d_fast(golden["points3d"][img], fly.skeleton, cam)
            want = jax_raster3d.render_frame_3d_fast(golden["points3d"][img],
                                                     jax_fly.skeleton, cam)
            assert got.shape == (200, 200, 3) and got.any()
            np.testing.assert_array_equal(got, want)
    points3d, _ = _human_points()
    for cam in range(4):
        np.testing.assert_array_equal(
            raster3d.render_frame_3d_fast(points3d[1], h36m.skeleton, cam, lim=1.0),
            jax_raster3d.render_frame_3d_fast(points3d[1], jax_h36m.skeleton, cam, lim=1.0))
    assert raster3d.camera_azimuth(5) == jax_raster3d.camera_azimuth(5)
    np.testing.assert_array_equal(raster3d._view_basis(-15.0, 30.0),
                                  jax_raster3d._view_basis(-15.0, 30.0))


@pytest.mark.parametrize("cam", [0, 4])
def test_render_frame_3d_matches_jax(cam):
    golden = _golden_3d()
    got = plot3d.render_frame_3d(golden["points3d"][3], fly.skeleton, cam)
    want = jax_plot3d.render_frame_3d(golden["points3d"][3], jax_fly.skeleton, cam)
    assert got.shape == (200, 200, 3) and got.any()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- Core.plot_2d


def _cores(working, golden_2d):
    """The port's and the JAX Core over ``working``, seeded with golden 2D."""
    cores = []
    for i, cls in enumerate((Core, JaxCore)):
        kw = {"device": "cpu"} if cls is Core else {}
        core = cls(input_folder=working, output_folder=working + f"_out{i}", num_images_max=0,
                   camera_ordering=ORDER, **kw)
        core.points2d = np.array(golden_2d["points2d"])
        core.conf = np.array(golden_2d["heatmap_confidence"])
        cores.append(core)
    return cores


def test_core_plot_2d_matches_jax_core(working_images, golden_2d):
    port, ref = _cores(working_images, golden_2d)
    for core in (port, ref):
        x, y = core.corrected_points2d(1, 6)[3]
        core.move_joint(1, 6, 3, x + 60.0, y - 40.0)          # a stored correction
    cases = [(0, 0, {}), (4, 8, {}), (2, 5, {"smooth": True}), (6, 12, {"smooth": True}),
             (1, 6, {"with_corrections": True}), (1, 6, {"with_corrections": True,
                                                          "joints": (0, 1, 2, 3, 4)})]
    for cam, img, kw in cases:
        got = port.plot_2d(cam, img, **kw)
        assert got.shape == (480, 960, 3)
        np.testing.assert_array_equal(got, ref.plot_2d(cam, img, **kw), err_msg=f"{cam} {img} {kw}")
    # the three point sets really differ, so the cases test three paths
    raw = port.plot_2d(1, 6)
    assert (raw != port.plot_2d(1, 6, with_corrections=True)).any()
    assert (raw != port.plot_2d(1, 6, smooth=True)).any()


def test_gui_pose_and_correction_views_match_jax(working_images, golden_2d):
    port, ref = _cores(working_images, golden_2d)
    ctls = [GuiController(port), JaxGuiController(ref)]
    for ctl in ctls:
        ctl.goto("4")
        assert ctl.set_mode("pose")
    for cam in (0, 5):
        np.testing.assert_array_equal(ctls[0].render(cam), ctls[1].render(cam))
    for ctl in ctls:
        assert ctl.set_mode("correction")
    np.testing.assert_array_equal(ctls[0].render(2), ctls[1].render(2))


# ------------------------------------------------------------- videos


def _render_golden_videos(tmp):
    """The port's videos of the golden result over the first NUM_FRAMES frames,
    as scripts/make_video_goldens.py renders the JAX package's."""
    work = os.path.join(tmp, "working")
    os.makedirs(work)
    for name in os.listdir(REFERENCE):
        if name.endswith(".jpg"):
            shutil.copy(os.path.join(REFERENCE, name), work)
    out_dir = _seed_result(work, _golden_3d())
    core = Core(input_folder=work, output_folder=out_dir, num_images_max=NUM_FRAMES,
                camera_ordering=ORDER, device="cpu")
    video.make_pose2d_video(core.plot_2d, core.num_images, core.input_folder,
                            core.output_folder, fps=FPS)
    video.make_pose3d_video(core.get_points3d(), core.plot_2d, core.num_images,
                            core.input_folder, core.output_folder, fps=FPS,
                            skeleton=core.config.skeleton)
    return {kind: os.path.join(out_dir, _video_name(kind, work)) for kind in ("2d", "3d")}


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    return _render_golden_videos(str(tmp_path_factory.mktemp("viz")))


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_videos_equal_the_golden_videos(rendered, kind):
    golden = _read_frames(os.path.join(GOLDEN_VIDEOS, f"video_pose{kind}.mp4"))
    new = _read_frames(rendered[kind])
    assert len(golden) == len(new) == NUM_FRAMES
    for i, (g, n) in enumerate(zip(golden, new)):
        assert g.shape == n.shape, f"frame {i}"
        np.testing.assert_array_equal(g, n, err_msg=f"frame {i}")
    assert new[0].shape[1] == video.VIDEO_WIDTH == jax_video.VIDEO_WIDTH


def test_cli_writes_both_videos(working_images, tmp_path):
    """``--skip-pose-estimation --video-2d --video-3d`` over a recording whose
    result pickle holds golden 2D: the calibration from it, then the videos."""
    golden = _golden_3d()
    out_dir = _seed_result(working_images, golden)
    rc = cli.main([working_images, "--output-folder", out_dir, "--skip-pose-estimation",
                   "--video-2d", "--video-3d", "-n", "2", "--output-fps", "5",
                   "--device", "cpu"])
    assert rc == 0
    for kind, rows in (("2d", 2), ("3d", 3)):
        frames = _read_frames(os.path.join(out_dir, _video_name(kind, working_images)))
        assert len(frames) == 2 and frames[0].shape[1] == video.VIDEO_WIDTH
    # nothing to do without estimation or videos
    assert cli.main([working_images, "--skip-pose-estimation", "--device", "cpu"]) == 0


def test_pooled_matplotlib_rows_match_jax():
    """The matplotlib 3D row over a pool of spawned worker processes is the
    JAX package's serial row, frame by frame."""
    golden = _golden_3d()
    got = list(video._render_3d_pooled(golden["points3d"], fly.skeleton, 2, workers=2))
    want = list(jax_video._render_3d_serial(golden["points3d"], jax_fly.skeleton, 2,
                                            "matplotlib"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
