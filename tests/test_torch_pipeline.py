"""The port's golden 2D->3D path as a whole vs the JAX package's, on the CPU.

The 105 golden JPEGs (15 frames x 7 cameras) go through the port's
``build_pipeline(device="cpu")`` and through ``bench.build_pipeline`` on its
folded forward (``DF3D_BENCH_FUSED=1``), both with rig registration on.
The port must decode the same argmax cells (p38 equal), give confidences
within 2e-5 and 3D points within rtol 1e-4 of JAX, and hold the golden
contract (points2d atol 0.02, confidence atol 0.002).

Also checked here: ``deepfly3d_torch/data/golden_t0.npz``, the frame-0
input and JAX reference that the chip smoke run compares against (the card's
machine has no JPEG decoder).  Regenerate it with

    python tests/test_torch_pipeline.py --write-golden-t0
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

# x64 on, as everywhere else in the suite, before bench.py (which turns it
# off at import) is imported: it decides the resize weights' last bit
import deepfly3d_tpu  # noqa: E402,F401

GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
CHECKPOINT = os.path.join(REPO, "weights", "hourglass_fly.npz")


def _import_bench():
    """Import bench.py without keeping the x64 switch it sets at import."""
    had = os.environ.get("DF3D_TPU_DISABLE_X64")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        if had is None:
            os.environ.pop("DF3D_TPU_DISABLE_X64", None)
        else:
            os.environ["DF3D_TPU_DISABLE_X64"] = had
    return bench


def _setup():
    from deepfly3d_tpu.models.hourglass import load_weights
    from deepfly3d_tpu.ops import geometry

    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    variables, spec = load_weights(CHECKPOINT)
    return variables, spec, calib


def _jax_pipeline(rig):
    """bench.build_pipeline on the folded forward."""
    bench = _import_bench()
    variables, spec, calib = _setup()
    frames, golden = bench.load_golden_frames()
    old = os.environ.get("DF3D_BENCH_FUSED")
    os.environ["DF3D_BENCH_FUSED"] = "1"
    try:
        pipe = bench.build_pipeline(spec, variables, calib, golden["camera_ordering"],
                                    (256, 512), rig=rig)
    finally:
        if old is None:
            os.environ.pop("DF3D_BENCH_FUSED", None)
        else:
            os.environ["DF3D_BENCH_FUSED"] = old
    return pipe, frames, golden, calib


def golden_t0_reference():
    """Frame 0 of the 7 golden cameras and the JAX folded path's output on it
    (rig off: the rig estimate needs 8 frames)."""
    pipe, frames, golden, _ = _jax_pipeline(rig=None)
    _, p38, conf = pipe(frames[:1])
    return {"frames": frames[0], "p38": np.asarray(p38), "conf": np.asarray(conf),
            "camera_ordering": np.asarray(golden["camera_ordering"])}


@pytest.fixture(scope="module")
def runs():
    from deepfly3d_torch.models.hourglass import load_weights as port_load
    from deepfly3d_torch.pipeline import build_pipeline

    jpipe, frames, golden, calib = _jax_pipeline(rig="auto")
    j3d, jp38, jconf = (np.asarray(a) for a in jpipe(frames))
    pvars, pspec = port_load(CHECKPOINT)
    ppipe = build_pipeline(pspec, pvars, calib, golden["camera_ordering"], (256, 512),
                           rig="auto", device="cpu")
    p3d, pp38, pconf = (t.numpy() for t in ppipe(frames))
    return {"jax": (j3d, jp38, jconf), "port": (p3d, pp38, pconf), "golden": golden,
            "frames": frames, "pipe": ppipe}


def test_same_argmax_cells(runs):
    assert runs["port"][1].shape == (7, 15, 38, 2)
    np.testing.assert_array_equal(runs["port"][1], runs["jax"][1])


def test_confidence_within_2e5(runs):
    assert runs["port"][2].shape == (7, 15, 19, 1)
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], atol=2e-5, rtol=0)


def test_points3d_within_rtol(runs):
    p3d, j3d = runs["port"][0], runs["jax"][0]
    assert p3d.shape == (15, 38, 3) and np.isfinite(p3d).all()
    np.testing.assert_allclose(p3d, j3d, rtol=1e-4, atol=1e-4 * np.abs(j3d).max())


def test_golden_contract(runs):
    golden = runs["golden"]
    pts_err = np.abs(runs["port"][1] - golden["points2d"]).max()
    conf_err = np.abs(runs["port"][2] - golden["heatmap_confidence"]).max()
    assert pts_err <= 0.02, pts_err
    assert conf_err <= 0.002, conf_err


def test_tf32_arithmetic_model_holds_the_golden_contract(runs):
    """The CUDA bottleneck kernel's arithmetic (three TF32 products per
    product, ``bottleneck_tf32_model``) in place of the float32 block, on all
    105 golden images: the same argmax cells as the port's float32 run,
    confidences within 2e-5 of JAX, and the golden confidence band."""
    from deepfly3d_torch.ops.bottleneck import bottleneck_tf32_model

    pipe = runs["pipe"]
    nets = list(pipe.nets().values())
    old = [net.block_fn for net in nets]
    for net in nets:
        net.block_fn = bottleneck_tf32_model
    try:
        _, p38, conf = (t.numpy() for t in pipe(runs["frames"]))
    finally:
        for net, fn in zip(nets, old):
            net.block_fn = fn
    np.testing.assert_array_equal(p38, runs["port"][1])
    np.testing.assert_allclose(conf, runs["jax"][2], atol=2e-5, rtol=0)
    conf_err = np.abs(conf - runs["golden"]["heatmap_confidence"]).max()
    assert conf_err <= 0.002, conf_err


def test_pose_estimator_infer_images_matches_jax(runs):
    from deepfly3d_tpu.models.inference import PoseEstimator as JaxEstimator
    from deepfly3d_torch.models.inference import PoseEstimator

    images = runs["frames"][0, 2:7]                    # 5 images, cameras 2-6
    flip = np.array([False, False, True, True, True])
    jest = JaxEstimator(CHECKPOINT, fused=True)
    jpts, jconf = jest.infer_images(images, flip, batch_size=2)
    pest = PoseEstimator(CHECKPOINT, device="cpu")
    ppts, pconf = pest.infer_images(images, flip, batch_size=2)
    assert ppts.shape == (5, 19, 2) and pconf.shape == (5, 19, 1)
    np.testing.assert_array_equal(ppts, np.asarray(jpts))
    np.testing.assert_allclose(pconf, np.asarray(jconf), atol=2e-5, rtol=0)


def test_committed_golden_t0_is_current(runs):
    """The chip smoke run's reference is the JAX output on these frames."""
    with np.load(GOLDEN_T0) as z:
        stored = {k: z[k] for k in z.files}
    np.testing.assert_array_equal(stored["frames"], runs["frames"][0])
    np.testing.assert_array_equal(stored["camera_ordering"], runs["golden"]["camera_ordering"])
    ref = golden_t0_reference()
    np.testing.assert_array_equal(stored["p38"], ref["p38"])
    np.testing.assert_array_equal(stored["conf"], ref["conf"])


def test_build_pipeline_requires_card_for_cuda(monkeypatch):
    from deepfly3d_torch.models.hourglass import load_weights as port_load
    from deepfly3d_torch.pipeline import build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pvars, pspec = port_load(CHECKPOINT)
    with pytest.raises(RuntimeError):
        build_pipeline(pspec, pvars, _setup()[2], list(range(7)), (256, 512))


if __name__ == "__main__" and "--write-golden-t0" in sys.argv:
    np.savez_compressed(GOLDEN_T0, **golden_t0_reference())
    print("wrote", GOLDEN_T0, os.path.getsize(GOLDEN_T0), "bytes")
