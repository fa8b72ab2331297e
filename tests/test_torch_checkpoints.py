"""Every shipped checkpoint through the port vs the JAX package, on the CPU.

Golden frame 0 (the 7 cameras of ``deepfly3d_torch/data/golden_t0.npz``,
right-side cameras flipped) goes through the port's
``PoseEstimator(device="cpu").infer_images`` and JAX's
``PoseEstimator(fused=False).infer_images`` (the flax graph: JAX's folded
forward covers only the conv stem with a 1x1 head).  The same argmax cells,
and confidences within 2e-5.  Cells are compared to 1e-6: on a grid that is
no power of two (the patchify checkpoint's 48x96) XLA's jit turns the
decode's division into a product with the reciprocal, one ulp off the IEEE
division the port computes; cells are at least 1/128 apart.

The p16 slice as a whole: the 15 golden frames through the port's
``build_pipeline`` with ``hourglass_fly_p16_tpu.npz`` and JAX's
``bench.build_pipeline`` (flax graph), rig registration on: p38 equal,
conf within 2e-5, points3d within rtol 1e-4.  The golden-contract errors
are printed for information only: the checkpoint was calibrated for a
bfloat16 TPU forward.

Also checked here: ``deepfly3d_torch/data/golden_t0_checkpoints.npz``, the
JAX output on golden frame 0 (rig off) for every shipped checkpoint and for
the cascade, which the chip smoke run compares against.  Regenerate it with

    python tests/test_torch_checkpoints.py --write
"""

import functools
import os
import pickle
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

import jax.numpy as jnp  # noqa: E402

import deepfly3d_tpu  # noqa: E402,F401  (x64 on before bench.py is imported)
from deepfly3d_tpu.models import cascade as jax_cascade  # noqa: E402
from deepfly3d_tpu.models.hourglass import load_weights as jax_load  # noqa: E402
from deepfly3d_tpu.models.inference import PoseEstimator as JaxEstimator  # noqa: E402
from deepfly3d_tpu.ops import geometry as jax_geo  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pipeline import _import_bench  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights")
GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
REFERENCE = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0_checkpoints.npz")
SHIPPED = ["hourglass_fly.npz", "hourglass_fly_tpu.npz", "hourglass_fly_p16.npz",
           "hourglass_fly_p16_tpu.npz", "hourglass_fly_fast_nearparity.npz"]
NEW = SHIPPED[1:]                      # the first is covered since the port began
STUDENT, TEACHER = "hourglass_fly_fast_nearparity.npz", "hourglass_fly.npz"
CELL_ATOL = 1e-6


def _frame0():
    with np.load(GOLDEN_T0) as z:
        frames, order = z["frames"], z["camera_ordering"]
    flip = np.zeros(7, bool)
    flip[order[4:]] = True
    return frames, flip, order


def _calib():
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        return jax_geo.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_frame0(name):
    """JAX PoseEstimator on golden frame 0: (pts (7, 19, 2), conf (7, 19, 1))."""
    frames, flip, _ = _frame0()
    est = JaxEstimator(os.path.join(WEIGHTS, name), fused=False)
    return tuple(np.asarray(a) for a in est.infer_images(frames, flip, batch_size=7))


def golden_t0_checkpoints_reference():
    """JAX's p38 (1, 7, 38, 2) -> (7, 1, 38, 2) and conf on golden frame 0 per
    shipped checkpoint, and the cascade's (rig off, R = 1 repaired image)."""
    frames, _, order = _frame0()
    order_j = jnp.asarray(order)
    out = {}
    for name in SHIPPED:
        pts, conf = _jax_frame0(name)
        pts19 = jnp.asarray(pts)[None].transpose(1, 0, 2, 3)        # (C, 1, 19, 2)
        p38 = jax_cascade._assemble38(pts19, order_j, order_j[:3], order_j[4:], 19)
        key = name[:-len(".npz")]
        out[f"{key}/p38"] = np.asarray(p38)
        out[f"{key}/conf"] = conf[None].transpose(1, 0, 2, 3)
    pipe = jax_cascade.build_cascade_pipeline(
        *jax_load(os.path.join(WEIGHTS, STUDENT)), *jax_load(os.path.join(WEIGHTS, TEACHER)),
        _calib(), order, jax_cascade.CascadeConfig(), rig=None)
    _, p38, conf = pipe(frames[None])
    out["cascade/p38"], out["cascade/conf"] = np.asarray(p38), np.asarray(conf)
    return out


@pytest.mark.parametrize("name", NEW)
def test_pose_estimator_frame0_matches_jax(name):
    from deepfly3d_torch.models.inference import PoseEstimator

    frames, flip, _ = _frame0()
    jpts, jconf = _jax_frame0(name)
    est = PoseEstimator(os.path.join(WEIGHTS, name), device="cpu")
    assert est.input_shape == tuple(est.spec.input_shape or (256, 512))
    ppts, pconf = est.infer_images(frames, flip, batch_size=7)
    assert ppts.shape == (7, 19, 2) and pconf.shape == (7, 19, 1)
    np.testing.assert_allclose(ppts, jpts, atol=CELL_ATOL, rtol=0)
    np.testing.assert_allclose(pconf, jconf, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def committed():
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", SHIPPED)
def test_committed_reference_is_current(committed, name):
    """The chip smoke run's golden phase compares against these arrays."""
    frames, _, order = _frame0()
    pts, conf = _jax_frame0(name)
    key = name[:-len(".npz")]
    order_j = jnp.asarray(order)
    p38 = jax_cascade._assemble38(jnp.asarray(pts)[None].transpose(1, 0, 2, 3), order_j,
                                  order_j[:3], order_j[4:], 19)
    np.testing.assert_array_equal(committed[f"{key}/p38"], np.asarray(p38))
    np.testing.assert_array_equal(committed[f"{key}/conf"], conf[None].transpose(1, 0, 2, 3))


def test_committed_cascade_reference_is_current(committed):
    frames, _, order = _frame0()
    pipe = jax_cascade.build_cascade_pipeline(
        *jax_load(os.path.join(WEIGHTS, STUDENT)), *jax_load(os.path.join(WEIGHTS, TEACHER)),
        _calib(), order, jax_cascade.CascadeConfig(), rig=None)
    _, p38, conf = pipe(frames[None])
    np.testing.assert_array_equal(committed["cascade/p38"], np.asarray(p38))
    np.testing.assert_array_equal(committed["cascade/conf"], np.asarray(conf))
    assert sorted(committed) == sorted(
        [f"{n[:-4]}/{k}" for n in SHIPPED for k in ("p38", "conf")]
        + ["cascade/p38", "cascade/conf"])


@pytest.fixture(scope="module")
def p16_slice():
    from deepfly3d_torch.models.hourglass import load_weights as port_load
    from deepfly3d_torch.pipeline import build_pipeline

    bench = _import_bench()
    frames, golden = bench.load_golden_frames()
    order = golden["camera_ordering"]
    calib = _calib()
    path = os.path.join(WEIGHTS, "hourglass_fly_p16_tpu.npz")
    jvars, jspec = jax_load(path)
    jpipe = bench.build_pipeline(jspec, jvars, calib, order, tuple(jspec.input_shape),
                                 rig="auto")
    jout = [np.asarray(a) for a in jpipe(frames)]
    pvars, pspec = port_load(path)
    ppipe = build_pipeline(pspec, pvars, calib, order, rig="auto", device="cpu")
    pout = [t.numpy() for t in ppipe(frames)]
    return {"jax": jout, "port": pout, "golden": golden}


def test_p16_slice_matches_jax(p16_slice):
    (p3d, p38, conf), (j3d, j38, jconf) = p16_slice["port"], p16_slice["jax"]
    assert p38.shape == (7, 15, 38, 2) and conf.shape == (7, 15, 19, 1)
    np.testing.assert_array_equal(p38, j38)
    np.testing.assert_allclose(conf, jconf, atol=2e-5, rtol=0)
    assert p3d.shape == (15, 38, 3) and np.isfinite(p3d).all()
    np.testing.assert_allclose(p3d, j3d, rtol=1e-4, atol=1e-4 * np.abs(j3d).max())
    golden = p16_slice["golden"]
    print(f"p16_tpu golden contract (information, float32 forward): pts_err "
          f"{np.abs(p38 - golden['points2d']).max()}, conf_err "
          f"{np.abs(conf - golden['heatmap_confidence']).max()}")


if __name__ == "__main__" and "--write" in sys.argv:
    np.savez_compressed(REFERENCE, **golden_t0_checkpoints_reference())
    print("wrote", REFERENCE, os.path.getsize(REFERENCE), "bytes")
