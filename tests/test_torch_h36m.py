"""The h36m profile in the port vs the JAX package.

* ``h36m_config()`` and the H3.6M skeleton field for field against JAX's.
* A seeded narrow h36m network (2 stacks, 32 features, depth 2, 17 joints,
  96x96 input; ``utils/synthetic.random_checkpoint``, batch norms with
  non-zero shifts) through both packages' estimators on a seeded 4-camera
  human scene: the same argmax cells, confidences within 2e-5.
* ``--profile h36m --solver lm`` through both CLIs on the JPEGs of
  ``tests/test_cli_profiles.py::TestH36MProfileCLI``: the result pickles
  within 1e-5.
* The full-width network (4 stacks, 128 features, depth 4, 384x384 input,
  96x96 heatmaps) on the first of ``deepfly3d_torch/data/h36m_t4.npz``'s
  frames: the JAX results that the chip smoke run's h36m phase holds the card
  to, reproduced by the port's plain forward on the CPU (1000x1000 frames
  through the preprocess's runtime-tap resize): the same cells wherever the
  top-2 margin exceeds 10x the confidence tolerance, confidences within 2e-5.
  Regenerate that file (JAX on the CPU, 8 frames x 4 cameras) with

      python tests/test_torch_h36m.py --write

* What the reference does with an h36m checkpoint that sits beside
  ``rig_template_fly.npz`` (it loads the fly template and registers no
  1000x1000 frame), and that its video layouts index the fly rig's cameras
  4-6, so ``--profile h36m --video-2d`` fails on a 4-camera result in both
  packages (ROADMAP.md Queue 3).
"""

import dataclasses
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepfly3d_tpu import cli as jax_cli  # noqa: E402
from deepfly3d_tpu import config as jax_config  # noqa: E402
from deepfly3d_tpu.models import hourglass as jax_hg  # noqa: E402
from deepfly3d_tpu.models import inference as jax_inf  # noqa: E402
from deepfly3d_tpu.ops import geometry as jax_geometry  # noqa: E402
from deepfly3d_tpu.skeletons import h36m as jax_h36m  # noqa: E402
from deepfly3d_torch import cli  # noqa: E402
from deepfly3d_torch import config  # noqa: E402
from deepfly3d_torch.models import inference as port_inf  # noqa: E402
from deepfly3d_torch.skeletons import h36m  # noqa: E402
from deepfly3d_torch.utils import synthetic  # noqa: E402

H36M_REF = os.path.join(REPO, "deepfly3d_torch", "data", "h36m_t4.npz")
FULL = dict(num_stacks=4, features=128, depth=4, num_classes=17, input_shape=(384, 384))
NARROW = dict(num_stacks=2, features=32, depth=2, num_classes=17, input_shape=(96, 96))
SEED, FRAMES, BATCH = 0, 8, 8
CONF_ATOL = 2e-5
# same argmax cell: cells are 1/96 apart; the jitted JAX decode divides by 96
# as a product with the reciprocal, one ulp off (ROADMAP.md Queue 3)
CELL_ATOL = 1e-6
TIE_MARGIN = 10 * CONF_ATOL     # cells are held equal where the top-2 margin exceeds this


def _margins(heatmaps):
    """(N, h, w, K) -> (N, K): the largest value minus the second largest."""
    flat = np.sort(heatmaps.reshape(heatmaps.shape[0], -1, heatmaps.shape[-1]), axis=1)
    return flat[:, -1] - flat[:, -2]


def _camera_major(frames):
    """(C, T, H, W, 3) -> (C * T, H, W, 3): the order of the ingest chunks."""
    return frames.reshape((-1,) + frames.shape[2:])


# ------------------------------------------------------------ the profile


def test_h36m_config_matches_jax():
    port, ref = config.h36m_config(), jax_config.h36m_config()
    assert port.name == ref.name == "h36m"
    assert port.num_cameras == ref.num_cameras == 4
    assert tuple(port.flip_cameras) == tuple(ref.flip_cameras) == ()
    assert port.procrustes_apply is ref.procrustes_apply is False
    assert port.network.num_predict == ref.network.num_predict == 17
    assert tuple(port.network.input_shape) == tuple(ref.network.input_shape) == (384, 384)
    assert os.path.basename(port.network.checkpoint) == \
        os.path.basename(ref.network.checkpoint) == "hourglass_h36m.npz"
    for name in ("line_thickness", "scatter_r", "reproj_thr_px", "streaming_auto_threshold"):
        assert getattr(port, name) == getattr(ref, name), name
    assert dataclasses.asdict(port.bp) == dataclasses.asdict(ref.bp)
    assert os.path.basename(port.calib_prior_path) == os.path.basename(ref.calib_prior_path)
    fly_port, fly_ref = config.fly_config(), jax_config.fly_config()
    assert (fly_port.line_thickness, fly_port.scatter_r) == \
        (fly_ref.line_thickness, fly_ref.scatter_r) == (5, 8)
    assert port.num_joints == ref.num_joints == 17


def test_h36m_skeleton_matches_jax():
    a, b = h36m.skeleton, jax_h36m.skeleton
    assert h36m.JOINT_NAMES == jax_h36m.JOINT_NAMES and h36m.num_joints == jax_h36m.num_joints
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(a.joint_colors_rgb(), b.joint_colors_rgb())
    for cam in range(4):
        np.testing.assert_array_equal(a.get_zorder(cam), b.get_zorder(cam))
    assert [a.get_limb_id(j) for j in range(17)] == [b.get_limb_id(j) for j in range(17)]
    from deepfly3d_torch import skeletons

    assert skeletons.h36m is h36m


# ------------------------------------------------------------ the network


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A seeded narrow h36m checkpoint and a 2-frame 4-camera scene at 96x96."""
    path = str(tmp_path_factory.mktemp("h36m") / "narrow.npz")
    synthetic.random_checkpoint(path, SEED, **NARROW)
    rig = synthetic.human_rig(size=96, focal=140.0)
    frames, _, _ = synthetic.human_frames(SEED, 2, rig, size=96, sigma=2.0)
    return path, _camera_major(frames)


def test_random_checkpoint_is_a_jax_checkpoint(narrow):
    """Every key and shape of ``init_params`` (and no other), and the spec
    ``load_weights`` reads back in both packages."""
    from flax.traverse_util import flatten_dict

    path, _ = narrow
    variables, spec = jax_hg.load_weights(path)
    want = flatten_dict(jax_hg.init_params(spec, (96, 96), jax.random.PRNGKey(0)), sep="/")
    got = flatten_dict(variables, sep="/")
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == np.float32 for k in want)
    assert (spec.num_stacks, spec.features, spec.depth, spec.num_classes, spec.input_shape) == \
        (2, 32, 2, 17, (96, 96))
    means = np.concatenate([v for k, v in got.items() if k.endswith("/mean")])
    assert np.abs(means).min() > 0 and (np.abs(means) > 0.05).mean() > 0.5


def test_narrow_h36m_estimators_match(narrow):
    path, images = narrow
    flip = np.zeros(len(images), bool)
    jest = jax_inf.PoseEstimator(path, rig_template=None)
    pest = port_inf.PoseEstimator(path, device="cpu", rig_template=None)
    j_pts, j_conf, j_hm = jest.infer_images(images, flip, BATCH, return_heatmaps=True)
    p_pts, p_conf = pest.infer_images(images, flip, BATCH)
    assert p_pts.shape == (8, 17, 2) and p_conf.shape == (8, 17, 1)
    np.testing.assert_allclose(p_conf, j_conf, atol=CONF_ATOL, rtol=0)
    sure = _margins(np.asarray(j_hm)) > TIE_MARGIN
    assert sure.mean() > 0.9                # the narrow net's heatmaps are flatter
    np.testing.assert_allclose(p_pts[sure], np.asarray(j_pts)[sure], atol=CELL_ATOL, rtol=0)


def test_full_width_first_frame_matches_committed_jax(tmp_path):
    """One frame of four 1000x1000 cameras through the 4-stack 128-wide
    network at 384x384 on the CPU (plain versions of every kernel)."""
    with np.load(H36M_REF) as z:
        ref = {k: z[k] for k in z.files}
    assert int(ref["seed"]) == SEED and int(ref["frames"]) == FRAMES
    assert [int(v) for v in ref["spec"]] == [4, 128, 4, 17, 384, 384]
    path = str(tmp_path / "h36m.npz")
    synthetic.random_checkpoint(path, SEED, **FULL)
    frames, _, _ = synthetic.human_frames(SEED, FRAMES, synthetic.human_rig())
    first = frames[:, 0]                                  # camera c, frame 0
    rows = np.arange(4) * FRAMES                          # their rows in the camera-major file
    est = port_inf.PoseEstimator(path, device="cpu", rig_template=None)
    pts, conf = est.infer_images(first, np.zeros(4, bool), BATCH)
    np.testing.assert_allclose(conf, ref["conf"][rows], atol=CONF_ATOL, rtol=0)
    sure = ref["margin"][rows] > TIE_MARGIN
    assert sure.mean() > 0.95
    np.testing.assert_allclose(pts[sure], ref["pts"][rows][sure], atol=CELL_ATOL, rtol=0)


def test_seeded_recording_writer(tmp_path):
    """``python -m deepfly3d_torch.utils.synthetic OUT``: JPEGs of the seeded
    frames, their rig as a calibration prior, the full-width checkpoint."""
    assert synthetic.main([str(tmp_path), "--frames", "1"]) == 0
    images = sorted(os.listdir(tmp_path / "images"))
    assert images == [f"camera_{c}_img_0.jpg" for c in range(4)]
    with open(tmp_path / "calib_prior.pkl", "rb") as f:
        prior = pickle.load(f)
    assert sorted(prior) == [0, 1, 2, 3] and prior[0]["distort"][0] == -0.15
    _, spec = jax_hg.load_weights(str(tmp_path / "hourglass_h36m_seed0.npz"))
    assert (spec.num_stacks, spec.features, spec.depth, spec.num_classes, spec.input_shape) == \
        (4, 128, 4, 17, (384, 384))
    from deepfly3d_torch.io import discovery

    frames, _, pixels = synthetic.human_frames(SEED, 1, synthetic.human_rig())
    decoded = discovery.read_image(str(tmp_path / "images" / "camera_2_img_0.jpg"))
    assert decoded.shape == (1000, 1000, 3)
    pool = lambda a: a.astype(float).reshape(100, 10, 100, 10, 3).mean(axis=(1, 3))  # noqa: E731
    assert np.abs(pool(decoded) - pool(frames[2, 0])).max() < 6      # JPEG, not the bytes
    assert ((pixels > 100) & (pixels < 900)).all()                  # every joint in frame


# ------------------------------------------------------------ the CLI


@pytest.fixture()
def h36m_recording(tmp_path):
    """tests/test_cli_profiles.py::TestH36MProfileCLI's recording: a
    4-camera 17-joint scene as JPEGs, its calibration prior and a tiny h36m
    checkpoint (flax's initialisation), for both CLIs."""
    import cv2

    C, T, J = 4, 2, 17
    H = W = 96
    rng = np.random.default_rng(7)
    base = rng.normal(size=(J, 3)) * 0.3
    pts = np.stack([base + rng.normal(size=(J, 3)) * 0.02 for _ in range(T)])
    K = np.asarray([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1]])
    prior = {}
    work = tmp_path / "h36m_rec"
    work.mkdir()
    for c in range(C):
        R = np.asarray(jax_geometry.rodrigues(jnp.asarray([0.0, np.pi / 2 * c, 0.0])))
        tvec = np.asarray([0.0, 0.0, 4.0])
        prior[c] = {"R": R, "tvec": tvec, "intr": K, "distort": np.zeros(5)}
        px = np.asarray(jax_geometry.project(
            jnp.asarray(pts.reshape(-1, 3)), jnp.asarray(R), jnp.asarray(tvec),
            jnp.asarray(K), jnp.zeros(5))).reshape(T, J, 2)
        yy, xx = np.mgrid[0:H, 0:W]
        for t in range(T):
            img = np.zeros((H, W, 3), np.float32)
            for j in range(J):
                img[..., j % 3] += 255 * np.exp(
                    -((yy - px[t, j, 1]) ** 2 + (xx - px[t, j, 0]) ** 2) / (2 * 3.0 ** 2))
            cv2.imwrite(str(work / f"camera_{c}_img_{t}.jpg"),
                        np.clip(img, 0, 255).astype(np.uint8))
    prior_path = tmp_path / "h36m_prior.pkl"
    with open(prior_path, "wb") as f:
        pickle.dump(prior, f)
    spec = jax_hg.HourglassSpec(num_stacks=1, features=16, depth=2, num_classes=J,
                                input_shape=(H, W))
    ckpt = tmp_path / "h36m_tiny.npz"
    jax_hg.save_weights(str(ckpt), jax_hg.init_params(spec, (H, W), jax.random.PRNGKey(0)), spec)
    return work, prior_path, ckpt


def _jax_main(argv):
    """``deepfly3d_tpu.cli.main`` reads sys.argv; its tests run parse + run."""
    return jax_cli.run(jax_cli.parse_cli_args(argv))


def _run_both(work, tmp_path, *flags):
    """Both CLIs over copies of ``work``; -> (port result, JAX result)."""
    saved = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", _jax_main, [])):
        rec = tmp_path / f"rec_{name}"
        shutil.copytree(work, rec)
        out = tmp_path / f"out_{name}"
        assert main([str(rec), "--output-folder", str(out), *flags, *extra]) == 0
        (result,) = list(out.glob("df3d_result_*.pkl"))
        with open(result, "rb") as f:
            saved.append(pickle.load(f))
    return saved


def test_h36m_cli_lm_matches_jax(h36m_recording, tmp_path):
    """The 2D within 1e-5 of JAX's; the lm solve on them held to JAX where
    the reference is reproducible: through 20 iterations (calibration and
    points within 1e-5), then by its final objective (1e-6 relative), at the
    CLI's 30 iterations and at convergence.  On this problem JAX's own result
    moves by 8e-6 for a one-in-1e15 change of its input at 30 iterations and
    by more than 1e-3 at 50 (ROADMAP.md Queue 3)."""
    from deepfly3d_tpu.ops import bundle_adjust as jax_ba
    from deepfly3d_torch.ops import bundle_adjust as port_ba

    work, prior_path, ckpt = h36m_recording
    port, ref = _run_both(work, tmp_path, "--profile", "h36m", "--calib-prior",
                          str(prior_path), "--checkpoint", str(ckpt), "--solver", "lm")
    assert port["points2d"].shape == (4, 2, 17, 2)
    assert port["heatmap_confidence"].shape == (4, 2, 17, 1)
    assert port["points3d"].shape == (2, 17, 3) and np.isfinite(port["points3d"]).all()
    assert list(port["camera_ordering"]) == list(ref["camera_ordering"]) == [0, 1, 2, 3]
    for key in ("points2d", "heatmap_confidence"):
        np.testing.assert_allclose(port[key], ref[key], atol=1e-5, rtol=0, err_msg=key)
    with open(prior_path, "rb") as f:
        prior = pickle.load(f)
    p2 = ref["points2d"]
    for iters in (20, None, 100):
        kw = {} if iters is None else {"max_iters": iters}
        want = jax_ba.bundle_adjust(p2, prior, (96, 96), solver="lm", **kw)
        got = port_ba.bundle_adjust(p2, prior, (96, 96), solver="lm", **kw)
        assert abs(got.cost_final - want.cost_final) <= 1e-6 * want.cost_final
        if iters == 20:
            for c in range(4):
                for key in ("R", "tvec"):
                    np.testing.assert_allclose(got.calib[c][key], want.calib[c][key],
                                               atol=1e-5, rtol=0, err_msg=f"{c} {key}")
            np.testing.assert_allclose(got.points3d, want.points3d, atol=1e-5, rtol=0)
    # the reference against itself, 50 iterations
    a, b = (jax_ba.bundle_adjust(p, prior, (96, 96), solver="lm", max_iters=50)
            for p in (p2, p2 * (1 + 1e-15)))
    assert max(float(np.abs(np.asarray(a.calib[c]["tvec"])
                            - np.asarray(b.calib[c]["tvec"])).max()) for c in range(4)) > 1e-3


def test_h36m_video_2d_indexes_the_fly_cameras(h36m_recording, tmp_path):
    """The 2D video's grid draws cameras (0, 1, 2) and (4, 5, 6), the fly
    rig's two sides, whatever the profile: on a 4-camera h36m result both
    CLIs fail on camera 4 (ROADMAP.md Queue 3; reproduced, not fixed)."""
    work, prior_path, ckpt = h36m_recording
    flags = ["--profile", "h36m", "--calib-prior", str(prior_path), "--checkpoint", str(ckpt),
             "--solver", "lm", "--video-2d"]
    errors = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", _jax_main, [])):
        rec = tmp_path / f"rec_{name}"
        shutil.copytree(work, rec)
        with pytest.raises(IndexError) as e:
            main([str(rec), "--output-folder", str(tmp_path / f"out_{name}"), *flags, *extra])
        errors.append(str(e.value))
        # the estimation and calibration before the videos were saved
        assert list((tmp_path / f"out_{name}").glob("df3d_result_*.pkl"))
    assert errors[0] == errors[1] and "index 4" in errors[0]


def test_h36m_checkpoint_beside_the_fly_template(tmp_path):
    """``rig_template="auto"`` finds ``rig_template_fly.npz`` beside any
    checkpoint, an h36m one too; both packages then register no frame whose
    size is not the fly template's (ROADMAP.md Queue 3)."""
    shutil.copy(os.path.join(REPO, "weights", "rig_template_fly.npz"), tmp_path)
    path = str(tmp_path / "hourglass_h36m.npz")
    synthetic.random_checkpoint(path, SEED, **NARROW)
    jest = jax_inf.PoseEstimator(path)
    pest = port_inf.PoseEstimator(path, device="cpu")
    assert jest.rig is not None and pest.rig is not None
    assert tuple(pest.rig.image_hw) == tuple(jest.rig.image_hw) == (480, 960)
    frames = np.random.default_rng(0).integers(0, 255, (8, 100, 100, 3), dtype=np.uint8)
    cams = np.repeat(np.arange(4), 2)
    gain, dy, dx = pest._register_chunk(frames, cams, {})
    j_out = jest._register_chunk(frames, cams, {})
    assert gain is None and not dy.any() and not dx.any()
    np.testing.assert_array_equal(j_out[0], frames)        # JAX returns the frames unrolled
    assert j_out[1] is None


# ------------------------------------------------------------ --write


def write_reference():
    """JAX's points, confidences and top-2 heatmap margins for the chip smoke
    run's h36m phase: 8 frames x 4 cameras of 1000x1000, camera-major, through
    the full-width network at batch 8 (``HourglassNet.apply``, on the CPU)."""
    import tempfile
    import time

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "h36m.npz")
        synthetic.random_checkpoint(path, SEED, **FULL)
        frames, _, _ = synthetic.human_frames(SEED, FRAMES, synthetic.human_rig())
        images = _camera_major(frames)
        est = jax_inf.PoseEstimator(path, rig_template=None)
        t0 = time.perf_counter()
        pts, conf, hm = est.infer_images(images, np.zeros(len(images), bool), BATCH,
                                         return_heatmaps=True)
        took = time.perf_counter() - t0
    margin = _margins(np.asarray(hm))
    np.savez_compressed(
        H36M_REF, pts=np.asarray(pts, np.float32), conf=np.asarray(conf, np.float32),
        margin=margin.astype(np.float32), seed=np.int64(SEED), frames=np.int64(FRAMES),
        spec=np.asarray([4, 128, 4, 17, 384, 384], np.int64))
    print(f"wrote {H36M_REF}: {len(images)} images in {took:.1f} s; conf in "
          f"[{float(np.min(conf)):.3f}, {float(np.max(conf)):.3f}]; "
          f"{int((margin <= TIE_MARGIN).sum())} of {margin.size} image-joints within "
          f"{TIE_MARGIN} of a tie")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_reference()
