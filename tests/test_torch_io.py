"""The port's io/ against the JAX package's: the same files, the same arrays.

Result pickles are written by one package and read by the other (arrays
equal, exact); ``PoseDB`` files likewise; file naming, discovery, video
probing and both decoders (native libjpeg/libav and OpenCV) give equal
results on the bundled recording.  ``StageTimer`` keeps the JAX metrics
layout.  Exact throughout: these are byte- and index-level contracts.
"""

import os
import pickle

import numpy as np
import pytest

from deepfly3d_tpu.io import discovery as jax_disc
from deepfly3d_tpu.io import native as jax_native
from deepfly3d_tpu.io import posedb as jax_posedb
from deepfly3d_tpu.io import result_schema as jax_rs
from deepfly3d_tpu.utils import profiling as jax_prof
from deepfly3d_torch.io import discovery as port_disc
from deepfly3d_torch.io import native as port_native
from deepfly3d_torch.io import posedb as port_posedb
from deepfly3d_torch.io import result_schema as port_rs
from deepfly3d_torch.utils import profiling as port_prof


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _result_args(golden_3d, seed):
    rng = np.random.default_rng(seed)
    calib = jax_rs.extract_calib(golden_3d)
    return dict(points2d=rng.random((7, 4, 38, 2)), camera_ordering=np.arange(7),
                heatmap_confidence=rng.random((7, 4, 19, 1)).astype(np.float32),
                calib=calib, points3d=rng.normal(size=(4, 38, 3)),
                points3d_wo_procrustes=rng.normal(size=(4, 38, 3)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_result_pickle_round_trip(tmp_path, golden_3d, writer):
    """A pickle written by one package loads in the other with equal arrays."""
    args = _result_args(golden_3d, seed=1)
    write, read = ((jax_rs, port_rs) if writer == "jax" else (port_rs, jax_rs))
    path = str(tmp_path / write.result_filename(str(tmp_path / "rec")))
    write.save_result(path, **args)
    loaded = read.load_result(path)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    _assert_tree_equal(loaded, raw)
    for k in ("points2d", "points3d", "points3d_wo_procrustes", "camera_ordering",
              "heatmap_confidence"):
        np.testing.assert_array_equal(loaded[k], args[k])
    _assert_tree_equal(read.extract_calib(loaded), jax_rs.extract_calib(loaded))
    # the same file bytes whichever package writes them
    other = str(tmp_path / "other.pkl")
    read.save_result(other, **args)
    with open(path, "rb") as f1, open(other, "rb") as f2:
        assert f1.read() == f2.read()


def test_result_pickle_without_calibration(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.random((7, 2, 38, 2))
    for mod in (jax_rs, port_rs):
        path = str(tmp_path / f"{mod.__name__}.pkl")
        mod.save_result(path, pts, np.arange(7), None)
    _assert_tree_equal(port_rs.load_result(str(tmp_path / f"{jax_rs.__name__}.pkl")),
                       jax_rs.load_result(str(tmp_path / f"{port_rs.__name__}.pkl")))


@pytest.mark.parametrize("folder", ["/data/exp1/images", "rel/path", "/a_b/c/"])
def test_result_filename_and_path(folder):
    assert port_rs.result_filename(folder) == jax_rs.result_filename(folder)
    assert port_rs.result_path("/out", folder) == jax_rs.result_path("/out", folder)


def test_golden_pickle_reads_the_same(golden_3d):
    path = os.path.join(os.path.dirname(__file__), "data", "reference_df3d",
                        "df3d_result_3d.pkl")
    _assert_tree_equal(port_rs.load_result(path), jax_rs.load_result(path))
    _assert_tree_equal(port_rs.extract_calib(golden_3d), jax_rs.extract_calib(golden_3d))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_posedb_write_reload_remove(tmp_path, writer):
    """Write corrections with one package, reload and remove them with the other."""
    write, read = ((jax_posedb, port_posedb) if writer == "jax"
                   else (port_posedb, jax_posedb))
    folder = str(tmp_path)
    rng = np.random.default_rng(3)
    db = write.PoseDB(folder, 7)
    pts = rng.random((38, 2))
    db.write(pts, 2, 5, True, [1, 4])
    db.write(pts * 0.5, 6, 0, False, [0])
    db.dump()
    other = read.PoseDB(folder, 7)
    assert other.db_path == db.db_path
    np.testing.assert_array_equal(other.read(2, 5), pts)
    assert other.read_modified_joints(2, 5) == [1, 4]
    assert other.has_key(6, 0) and not other.has_key(6, 1)
    px_o = other.manual_corrections((960, 480))
    px_w = db.manual_corrections((960, 480))
    np.testing.assert_array_equal(px_o[2][5], px_w[2][5])
    other.remove_corrections(2, 5)
    other.dump()
    again = write.PoseDB(folder, 7)
    assert again.read(2, 5) is None and again.read_modified_joints(2, 5) == []
    np.testing.assert_array_equal(again.read(6, 0), pts * 0.5)


@pytest.mark.parametrize("cam,img,pad", [(0, 0, True), (3, 17, False), (6, 123456, True)])
def test_image_naming(cam, img, pad):
    name = port_disc.construct_image_name(cam, img, pad)
    assert name == jax_disc.construct_image_name(cam, img, pad)
    assert port_disc.parse_img_name(name + ".jpg") == jax_disc.parse_img_name(name + ".jpg")
    assert port_disc.parse_vid_name(f"camera_{cam}.mp4") == cam
    with pytest.raises(ValueError):
        port_disc.parse_img_name("frame_1.jpg")


def test_discovery_on_the_recording(working_images, tmp_path):
    assert port_disc.get_max_img_id(working_images) == jax_disc.get_max_img_id(working_images) == 14
    assert port_disc.image_path_template(working_images) == \
        jax_disc.image_path_template(working_images)
    with pytest.raises(FileNotFoundError):
        port_disc.get_max_img_id(str(tmp_path))
    path = os.path.join(working_images, "camera_3_img_7.jpg")
    np.testing.assert_array_equal(port_disc.read_image(path), jax_disc.read_image(path))


def test_video_discovery(working_videos):
    assert port_disc.list_videos(working_videos) == jax_disc.list_videos(working_videos)
    assert port_disc.probe_fps(working_videos) == jax_disc.probe_fps(working_videos)
    assert port_disc.video_frame_count(working_videos) == \
        jax_disc.video_frame_count(working_videos) == 15
    vid = os.path.join(working_videos, "camera_2.mp4")
    np.testing.assert_array_equal(port_disc.read_video_frame(vid, 4),
                                  jax_disc.read_video_frame(vid, 4))


def test_expand_and_delete_images(working_videos, tmp_path):
    """Expanding with either package gives the same JPEG bytes; deleting
    removes only frames whose video is there."""
    import shutil

    other = tmp_path / "other"
    shutil.copytree(working_videos, other)
    port_disc.expand_videos(working_videos)
    jax_disc.expand_videos(str(other))
    names = sorted(f for f in os.listdir(working_videos) if f.endswith(".jpg"))
    assert names == sorted(f for f in os.listdir(other) if f.endswith(".jpg"))
    assert len(names) == 7 * 15
    for name in names[::17]:
        with open(os.path.join(working_videos, name), "rb") as a, \
                open(os.path.join(other, name), "rb") as b:
            assert a.read() == b.read(), name
    port_disc.expand_videos(working_videos)       # idempotent
    assert len([f for f in os.listdir(working_videos) if f.endswith(".jpg")]) == 7 * 15
    os.remove(os.path.join(working_videos, "camera_6.mp4"))
    port_disc.delete_images(working_videos)
    left = [f for f in os.listdir(working_videos) if f.endswith(".jpg")]
    assert left and all(f.startswith("camera_6_") for f in left)


def test_native_jpeg_batch_matches_jax(working_images):
    if not (port_native.available() and jax_native.available()):
        pytest.skip(f"native ingest library does not load here ({port_native.load_error})")
    paths = [os.path.join(working_images, f"camera_{c}_img_{t}.jpg")
             for c in (0, 4) for t in (0, 9)]
    got = port_native.decode_jpeg_batch(paths, 480, 960, num_threads=2)
    np.testing.assert_array_equal(got, jax_native.decode_jpeg_batch(paths, 480, 960, 2))
    with pytest.raises(IOError):
        port_native.decode_jpeg_batch(paths + ["/nonexistent.jpg"], 480, 960)


def test_native_video_reader_matches_jax(working_videos):
    if not (port_native.available() and jax_native.available()):
        pytest.skip(f"native ingest library does not load here ({port_native.load_error})")
    vid = os.path.join(working_videos, "camera_5.mp4")
    with port_native.VideoReader(vid) as pv, jax_native.VideoReader(vid) as jv:
        assert (pv.width, pv.height, pv.fps) == (jv.width, jv.height, jv.fps)
        frames = list(pv)
        want = list(jv)
    assert len(frames) == len(want) == 15
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a, b)


def test_native_probe_reports_headers():
    found = port_native.headers_found()
    assert set(found) == {"jpeglib.h", "libavcodec/avcodec.h", "libavformat/avformat.h",
                          "libswscale/swscale.h"}
    assert port_native.available() == (port_native.load_error is None)


def test_stage_timer_matches_jax_layout():
    timers = [port_prof.StageTimer(), jax_prof.StageTimer()]
    for t in timers:
        for name in ("setup", "pose2d", "pose2d"):
            with t.stage(name):
                pass
        with pytest.raises(RuntimeError):
            with t.stage("calibrate"):
                raise RuntimeError("inside a stage")
    m_port, m_jax = (t.metrics(frames=10) for t in timers)
    assert sorted(m_port) == sorted(m_jax)
    for name in ("setup", "pose2d", "calibrate"):
        assert m_port[name]["calls"] == m_jax[name]["calls"]
    assert sorted(m_port["_summary"]) == sorted(m_jax["_summary"])
    assert "_summary" not in port_prof.StageTimer().metrics()
