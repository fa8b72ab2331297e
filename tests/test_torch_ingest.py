"""The port's folder and video ingest (``infer_folder`` / ``infer_videos``) vs JAX.

A tiny random hourglass (the ``tests/test_inference.py`` spec, saved with the
JAX ``save_weights``) runs over the bundled recording in both packages, the
JAX side on its folded forward (``fused=True``, the port's own arithmetic):
points within 1e-6 (the same argmax cells), confidences within 2e-5.
Chunking and batch padding never change a result.  On a drifted copy of the
recording (planted rolls and a 1.06 brightening, written as JPEGs) the
per-recording registration finds the same (dy, dx, gain) as JAX and the
points agree; the port hands the shift to the preprocess kernel's roll
instead of rolling the frames.  The gain quirk of the reference is pinned:
the ingest path multiplies the network input by the *measured* gain, not by
its inverse.

At full width, ``deepfly3d_torch/data/ingest_t16.npz`` holds the JAX
package's points and confidences for the chip smoke run's ingest phase
(golden frame 0 tiled to 16 frames per camera, drifted; the conv
checkpoint at batch 8); the port on the CPU must give the same cells and
confidences within 2e-5.  Regenerate it with

    python tests/test_torch_ingest.py --write

and print the gain quirk's effect at full width on those frames with

    python tests/test_torch_ingest.py --gain-quirk
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

import jax  # noqa: E402

from deepfly3d_tpu.models import hourglass as jax_hg  # noqa: E402
from deepfly3d_tpu.models import inference as jax_inf  # noqa: E402
from deepfly3d_tpu.ops import canonicalize as jax_rig  # noqa: E402
from deepfly3d_torch.models import inference as port_inf  # noqa: E402
from deepfly3d_torch.ops import canonicalize as port_rig  # noqa: E402

TEMPLATE = os.path.join(REPO, "weights", "rig_template_fly.npz")
CHECKPOINT = os.path.join(REPO, "weights", "hourglass_fly.npz")
REFERENCE = os.path.join(REPO, "tests", "data", "reference")
INGEST_REF = os.path.join(REPO, "deepfly3d_torch", "data", "ingest_t16.npz")
TINY = jax_hg.HourglassSpec(num_stacks=1, features=16, depth=2, num_blocks=1, num_classes=19)
FLIP = [4, 5, 6]
PTS_ATOL, CONF_ATOL = 1e-6, 2e-5
# planted on the drifted copy of the recording: rolls (rows, columns) per
# camera and one brightened camera
DRIFT_DY, DRIFT_DX = (2, 0, -5, 0, 7, 0, -1), (-3, 0, 4, 0, 0, 6, -8)
DRIFT_GAIN = (1.0, 1.0, 1.0, 1.06, 1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    variables = jax_hg.init_params(TINY, (64, 128), jax.random.PRNGKey(0))
    jax_hg.save_weights(path, variables, TINY)
    return path


def _pair(checkpoint, rig_template="auto"):
    jest = jax_inf.PoseEstimator(checkpoint, input_shape=(64, 128), fused=True,
                                 rig_template=rig_template)
    pest = port_inf.PoseEstimator(checkpoint, input_shape=(64, 128), device="cpu",
                                  rig_template=rig_template)
    return jest, pest


def _close(got, want):
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert got[0].dtype == want[0].dtype == np.float64
    np.testing.assert_allclose(got[0], want[0], atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=CONF_ATOL, rtol=0)


@pytest.mark.parametrize("batch_size", [3, 4, 8])
def test_infer_folder_matches_jax(tiny_checkpoint, working_images, batch_size):
    jest, pest = _pair(tiny_checkpoint)
    assert pest.rig is None and jest.rig is None         # no template beside a tmp checkpoint
    want = jest.infer_folder(working_images, FLIP, max_img_id=2, batch_size=batch_size)
    got = pest.infer_folder(working_images, FLIP, max_img_id=2, batch_size=batch_size)
    assert got[0].shape == (7, 3, 19, 2) and got[1].shape == (7, 3, 19, 1)
    _close(got, want)


def test_batch_padding_consistency(tiny_checkpoint, working_images):
    _, pest = _pair(tiny_checkpoint)
    a = pest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=3)
    b = pest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=14)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=1e-5, rtol=0)


def test_infer_folder_chunked_matches_unchunked(tiny_checkpoint, working_images):
    """Chunks are aligned to the batch, so a chunk's batches hold the same
    images.  The ragged last chunk (1 image) is padded with its own first
    images, as in the JAX package, which makes a batch of 2: the CPU
    convolutions of another batch size sum in another order, so the
    confidences agree to 1e-6 there, the points exactly."""
    jest, pest = _pair(tiny_checkpoint)
    full = pest.infer_folder(working_images, FLIP, max_img_id=2, batch_size=4,
                             chunk_images=10_000)
    chunked = pest.infer_folder(working_images, FLIP, max_img_id=2, batch_size=4,
                                chunk_images=5)
    np.testing.assert_array_equal(full[0], chunked[0])
    np.testing.assert_array_equal(full[1][:, :2], chunked[1][:, :2])
    np.testing.assert_allclose(full[1], chunked[1], atol=1e-6, rtol=0)
    _close(chunked, jest.infer_folder(working_images, FLIP, max_img_id=2, batch_size=4,
                                      chunk_images=5))


def test_return_heatmap_matches_jax(tiny_checkpoint, working_images):
    jest, pest = _pair(tiny_checkpoint)
    want = jest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=4,
                             return_heatmap=True)
    got = pest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=4,
                            return_heatmap=True)
    chunked = pest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=4,
                                return_heatmap=True, chunk_images=4)
    assert got[2].shape == want[2].shape == (7, 2, 16, 32, 19)
    _close(got[:2], want[:2])
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=CONF_ATOL, rtol=0)
    np.testing.assert_array_equal(chunked[2], got[2])


def test_infer_videos_matches_jax(tiny_checkpoint, working_videos):
    jest, pest = _pair(tiny_checkpoint)
    want = jest.infer_videos(working_videos, FLIP, batch_size=8, max_frames=3)
    got = pest.infer_videos(working_videos, FLIP, batch_size=8, max_frames=3)
    assert got[0].shape == (7, 3, 19, 2)
    _close(got, want)
    chunked = pest.infer_videos(working_videos, FLIP, batch_size=8, max_frames=3,
                                chunk_frames=2)
    np.testing.assert_array_equal(chunked[0], got[0])
    np.testing.assert_allclose(chunked[1], got[1], atol=1e-5, rtol=0)


def test_soft_argmax_is_not_ported(tiny_checkpoint, working_images):
    """Soft-argmax decoding, once not ported, now runs on the ingest path: the
    tiny net's refined points against the JAX estimator's."""
    jest = jax_inf.PoseEstimator(tiny_checkpoint, input_shape=(64, 128), fused=True,
                                 soft_argmax=True)
    pest = port_inf.PoseEstimator(tiny_checkpoint, input_shape=(64, 128), device="cpu",
                                  soft_argmax=True)
    want = jest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=4)
    got = pest.infer_folder(working_images, FLIP, max_img_id=1, batch_size=4)
    np.testing.assert_allclose(got[1], want[1], atol=CONF_ATOL, rtol=0)
    sure = want[1][..., 0] >= 0.1 * want[1].max()
    np.testing.assert_allclose(got[0][sure], want[0][sure], atol=1e-4, rtol=0)


# ------------------------------------------------------------------ drifted


@pytest.fixture(scope="module")
def drifted_recording(tmp_path_factory):
    """The 15 bundled frames per camera, rolled by (DRIFT_DY, DRIFT_DX) and
    scaled by DRIFT_GAIN, written as JPEGs (quality 95)."""
    import cv2

    folder = tmp_path_factory.mktemp("drifted")
    for c in range(7):
        for t in range(15):
            name = f"camera_{c}_img_{t}.jpg"
            img = cv2.imread(os.path.join(REFERENCE, name), cv2.IMREAD_COLOR)
            img = np.roll(img, (DRIFT_DY[c], DRIFT_DX[c]), axis=(0, 1)).astype(np.float32)
            img = np.clip(np.rint(img * np.float32(DRIFT_GAIN[c])), 0, 255).astype(np.uint8)
            cv2.imwrite(str(folder / name), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(folder)


def _decoded(folder, T=15):
    paths = [os.path.join(folder, f"camera_{c}_img_{t}.jpg") for c in range(7) for t in range(T)]
    return port_inf._read_images_threaded(paths), np.repeat(np.arange(7), T)


def test_drifted_registration_matches_jax(tiny_checkpoint, drifted_recording):
    jest, pest = _pair(tiny_checkpoint, rig_template=TEMPLATE)
    images, cams = _decoded(drifted_recording)
    jreg, preg = {}, {}
    jimages, jgain, jdy, jdx = jest._register_chunk(images, cams, jreg)
    pgain, pdy, pdx = pest._register_chunk(images, cams, preg)
    assert preg == jreg
    for c in range(7):       # the bundled recording registers to the identity
        assert preg[c][:2] == (DRIFT_DY[c], DRIFT_DX[c]), (c, preg[c])
        assert (preg[c][2] != 1.0) == (DRIFT_GAIN[c] != 1.0), (c, preg[c])
    np.testing.assert_array_equal(pdy, jdy)
    np.testing.assert_array_equal(pdx, jdx)
    np.testing.assert_array_equal(pgain, jgain)
    # the port does not roll the frames on the host: the kernel's shift does
    np.testing.assert_array_equal(
        jimages[cams == 0], port_rig.apply_np(images[cams == 0], DRIFT_DY[0], DRIFT_DX[0]))


def test_drifted_infer_folder_matches_jax(tiny_checkpoint, drifted_recording):
    jest, pest = _pair(tiny_checkpoint, rig_template=TEMPLATE)
    want = jest.infer_folder(drifted_recording, FLIP, max_img_id=14, batch_size=8)
    got = pest.infer_folder(drifted_recording, FLIP, max_img_id=14, batch_size=8)
    _close(got, want)
    # the points are in the provided frame: not those of the unregistered run
    _, plain = _pair(tiny_checkpoint, rig_template=None)
    unregistered = plain.infer_folder(drifted_recording, FLIP, max_img_id=14, batch_size=8)
    assert np.abs(got[0] - unregistered[0]).max() > 1e-3


def test_first_short_chunk_caches_the_identity(tiny_checkpoint, drifted_recording):
    """A camera first seen in a chunk of fewer than MIN_EST_FRAMES frames keeps
    the identity for the whole recording, in both packages (ADVICE r5)."""
    jest, pest = _pair(tiny_checkpoint, rig_template=TEMPLATE)
    assert port_rig.MIN_EST_FRAMES == jax_rig.MIN_EST_FRAMES == 8
    kw = dict(max_img_id=14, batch_size=4, chunk_images=4)
    got = pest.infer_folder(drifted_recording, FLIP, **kw)
    _close(got, jest.infer_folder(drifted_recording, FLIP, **kw))
    _, plain = _pair(tiny_checkpoint, rig_template=None)
    unregistered = plain.infer_folder(drifted_recording, FLIP, **kw)
    np.testing.assert_array_equal(got[0], unregistered[0])


def test_ingest_multiplies_by_the_measured_gain(tiny_checkpoint, drifted_recording):
    """The reference quirk, reproduced: the ingest path multiplies the network
    input by the measured gain (``frames.mean / template.mean``), where the
    device pipelines multiply by its inverse (``gain_correction``)."""
    jest, pest = _pair(tiny_checkpoint, rig_template=TEMPLATE)
    images, cams = _decoded(drifted_recording)
    sel = cams == 3                                      # the brightened camera
    frames, flip = images[sel], np.zeros(15, bool)
    measured = port_rig.estimate_camera_np(frames, port_rig.load_template(TEMPLATE), 3)[2]
    assert abs(measured - 1.06) < 0.01
    got = pest.infer_chunks([(frames, cams[sel], flip)], batch_size=8)
    as_measured = pest.infer_images(frames, flip, 8, gain=np.full(15, measured, np.float32))
    inverse = pest.infer_images(frames, flip, 8, gain=np.full(15, 1.0 / measured, np.float32))
    np.testing.assert_array_equal(got[0], as_measured[0])
    np.testing.assert_array_equal(got[1], as_measured[1])
    assert np.abs(got[1] - inverse[1]).max() > 1e-3
    # and JAX's ingest does the same
    jimages, jgain, _, _ = jest._register_chunk(frames, cams[sel], {})
    np.testing.assert_array_equal(jgain, np.float32(measured))
    jpts, jconf = jest.infer_images(jimages, flip, batch_size=8, gain=jgain)
    np.testing.assert_allclose(got[0], jpts, atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], jconf, atol=CONF_ATOL, rtol=0)


def test_register_chunk_off_without_a_matching_template(tiny_checkpoint):
    _, pest = _pair(tiny_checkpoint, rig_template=TEMPLATE)
    small = np.zeros((9, 240, 480, 3), np.uint8)         # not the template's frame size
    reg = {}
    gain, dy, dx = pest._register_chunk(small, np.zeros(9, int), reg)
    assert gain is None and not dy.any() and not dx.any() and reg == {}


# ----------------------------------------------------------- full width


def _ingest_inputs(drift=True):
    sys.path.insert(0, REPO)
    import chip_smoke

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        frames0, order = z["frames"], z["camera_ordering"]
    return (chip_smoke,) + chip_smoke.ingest_chunk(frames0, order, drift)[0]


def write_reference():
    """JAX's folded path on the chip smoke run's ingest frames -> INGEST_REF."""
    chip_smoke, frames, cams, flip = _ingest_inputs()
    est = jax_inf.PoseEstimator(CHECKPOINT, fused=True)
    reg = {}
    images, gain, dy, dx = est._register_chunk(frames, cams, reg)
    pts, conf = est.infer_images(images, flip, batch_size=chip_smoke.INGEST_BATCH, gain=gain)
    pts = jax_rig.adjust_points_raw(np.asarray(pts), dy, dx, flip, est.rig.image_hw)
    C = frames.shape[0] // chip_smoke.INGEST_T
    np.savez_compressed(
        INGEST_REF, pts=np.asarray(pts, np.float32), conf=np.asarray(conf, np.float32),
        dy=np.array([reg[c][0] for c in range(C)]), dx=np.array([reg[c][1] for c in range(C)]),
        gain=np.array([reg[c][2] for c in range(C)], np.float64))
    print(f"wrote {INGEST_REF}: registration {reg}")


def test_ingest_reference_matches_port_at_full_width():
    """The conv checkpoint at batch 8 on the chip smoke run's 112 drifted
    frames: the port's chunk loop on the CPU gives JAX's registration, cells
    and confidences (2e-5), and the registration finds the planted drift."""
    chip_smoke, frames, cams, flip = _ingest_inputs()
    with np.load(INGEST_REF) as z:
        ref = {k: z[k] for k in z.files}
    est = port_inf.PoseEstimator(CHECKPOINT, device="cpu")
    reg = {}
    pts, conf = est.infer_chunks([(frames, cams, flip)], chip_smoke.INGEST_BATCH,
                                 registration=reg)
    C = len(reg)
    assert [reg[c][0] for c in range(C)] == ref["dy"].tolist()
    assert [reg[c][1] for c in range(C)] == ref["dx"].tolist()
    np.testing.assert_array_equal([reg[c][2] for c in range(C)], ref["gain"])
    clean_reg = {}
    est._register_chunk(_ingest_inputs(drift=False)[1], cams, clean_reg)
    for c in range(C):
        assert reg[c][0] - clean_reg[c][0] == chip_smoke.INGEST_DY[c]
        assert reg[c][1] - clean_reg[c][1] == chip_smoke.INGEST_DX[c]
        assert (reg[c][2] != clean_reg[c][2]) == (chip_smoke.INGEST_GAIN[c] != 1.0)
    np.testing.assert_allclose(pts, ref["pts"], atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(conf, ref["conf"], atol=CONF_ATOL, rtol=0)


def print_gain_quirk():
    """The quirk's size at full width: the port's ingest on the brightened
    cameras of the chip smoke run's frames, with the measured gain (as the
    reference does it) against the inverse (as the pipelines do it)."""
    chip_smoke, frames, cams, flip = _ingest_inputs()
    est = port_inf.PoseEstimator(CHECKPOINT, device="cpu")
    gain, dy, dx = est._register_chunk(frames, cams, {})
    for c in np.flatnonzero(np.asarray(chip_smoke.INGEST_GAIN) != 1.0):
        sel = cams == c
        args = (frames[sel], flip[sel], chip_smoke.INGEST_BATCH)
        shift = (dy[sel], dx[sel])
        a = est.infer_images(*args, gain=gain[sel], shift=shift)
        b = est.infer_images(*args, gain=(1.0 / gain[sel]).astype(np.float32), shift=shift)
        moved = np.abs(a[0] - b[0]).max(-1) > PTS_ATOL
        print(f"camera {c}: measured gain {gain[sel][0]}; against 1/gain {int(moved.sum())} of "
              f"{moved.size} points move (max {np.abs(a[0] - b[0]).max()}), conf by up to "
              f"{np.abs(a[1] - b[1]).max()}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_reference()
    if "--gain-quirk" in sys.argv:
        print_gain_quirk()
