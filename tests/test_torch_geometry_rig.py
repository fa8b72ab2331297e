"""Port's rig registration and DLT triangulation vs the JAX package's.

Rig registration: planted integer shifts and gains on frames built from the
shipped template's own profiles; the integer shifts must agree exactly, the
gains and the adjusted points to float32 rounding.  Triangulation:
``method="normal"`` in float32 on the golden 2D points and data/calib.pkl,
rtol 1e-4 (the batched sums run in another order), with zeros where fewer
than two cameras see a joint.  Projection with non-zero distortion and the
reprojection residuals and error: rtol 1e-5 against the JAX functions
(vmapped over cameras there, a leading camera dimension in the port).

The float64 host geometry of ``Core``: ``triangulate(method="svd",
distort=...)``, ``rodrigues`` / ``inv_rodrigues``, ``undistort_points``,
``procrustes_separate`` and ``filter_batch`` against the JAX functions under
x64, within 1e-10 (of the output's magnitude where it is not of order one).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfly3d_tpu.ops import canonicalize as jax_rig
from deepfly3d_tpu.ops import geometry as jax_geo
from deepfly3d_torch.ops import canonicalize as port_rig
from deepfly3d_torch.ops import geometry as port_geo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = os.path.join(REPO, "weights", "rig_template_fly.npz")


def _frames_from_template(tpl, T, dy, dx, gain, seed):
    """(T, C, H, W, 3) uint8 whose profiles carry the template's structure,
    rolled by (dy, dx) per camera and scaled by ``gain``."""
    rng = np.random.default_rng(seed)
    C = tpl.num_cameras
    H, W = tpl.image_hw
    base = (tpl.row_profile[:, :, None] + tpl.col_profile[:, None, :]) / 2.0
    frames = np.empty((T, C, H, W, 3), np.uint8)
    for c in range(C):
        img = np.roll(base[c], (dy[c], dx[c]), axis=(0, 1)) * gain[c]
        noise = rng.normal(0, 2.0, size=(T, H, W, 1))
        frames[:, c] = np.clip(img[None, :, :, None] + noise, 0, 255).astype(np.uint8)
    return frames


@pytest.mark.parametrize("case", ["identity", "shift_and_gain"])
def test_rig_registration_matches_jax(case):
    tpl = jax_rig.load_template(TEMPLATE)
    C = tpl.num_cameras
    if case == "identity":
        dy, dx, gain = [0] * C, [0] * C, [1.0] * C
    else:
        dy = [2, -3, 0, 5, -1, 0, 4][:C]
        dx = [-2, 1, 6, 0, -4, 3, 0][:C]
        gain = [1.05, 1.0, 0.93, 1.0, 1.04, 0.96, 1.0][:C]
    frames = _frames_from_template(tpl, 8, dy, dx, gain, seed=1)

    jdy, jdx, jgain = jax_rig.estimate_tc(jnp.asarray(frames), jax_rig.prepare(tpl))
    ta = port_rig.prepare(port_rig.load_template(TEMPLATE), "cpu")
    pdy, pdx, pgain = port_rig.estimate_tc(torch.from_numpy(frames), ta)
    np.testing.assert_array_equal(pdy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(pdx.numpy(), np.asarray(jdx))
    np.testing.assert_allclose(pgain.numpy(), np.asarray(jgain), rtol=1e-6)
    if case == "shift_and_gain":
        np.testing.assert_array_equal(pdy.numpy(), dy)
        np.testing.assert_array_equal(pdx.numpy(), dx)
    else:
        np.testing.assert_array_equal(pgain.numpy(), np.ones(C, np.float32))

    jshift = np.asarray(jax_rig.apply_shift_tc(jnp.asarray(frames), jdy, jdx))
    pshift = port_rig.apply_shift_tc(torch.from_numpy(frames), pdy, pdx).numpy()
    np.testing.assert_array_equal(pshift, jshift)

    np.testing.assert_allclose(
        port_rig.gain_correction(pgain).numpy(),
        np.asarray(jax_rig.gain_correction(jgain, jnp.float32)), rtol=1e-6)

    rng = np.random.default_rng(2)
    p38 = rng.uniform(0.05, 0.95, size=(C, 8, 38, 2)).astype(np.float32)
    p38[0, :, 20:] = 0.0
    p38[4, :, :19, 1] = 1.0                              # flip artifact
    jadj = np.asarray(jax_rig.adjust_points38(jnp.asarray(p38), jdy, jdx, tpl.image_hw))
    padj = port_rig.adjust_points38(torch.from_numpy(p38), pdy, pdx, tpl.image_hw).numpy()
    np.testing.assert_array_equal(padj, jadj)


def test_find_template():
    ckpt = os.path.join(REPO, "weights", "hourglass_fly.npz")
    assert port_rig.find_template(ckpt) == jax_rig.find_template(ckpt)


@pytest.fixture(scope="module")
def golden_calib():
    with open(os.path.join(REPO, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"), "rb") as f:
        golden = pickle.load(f)
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = pickle.load(f)
    return golden, calib


def test_triangulate_normal_matches_jax(golden_calib):
    golden, calib = golden_calib
    R, tvec, intr, _ = port_geo.calib_to_arrays(calib, 7, dtype=np.float32)
    jR, jt, jK, _ = jax_geo.calib_to_arrays(calib, 7, dtype=np.float32)
    np.testing.assert_array_equal(R, jR)
    p38 = np.asarray(golden["points2d"], np.float32)
    # one joint seen by a single camera: it must come out as zeros
    p38[:, 0, 0] = 0.0
    p38[2, 0, 0] = (0.5, 0.5)
    want = np.asarray(jax_geo.triangulate(
        jnp.asarray(p38), jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr),
        (960, 480), method="normal"))
    got = port_geo.triangulate(
        torch.from_numpy(p38), torch.from_numpy(R), torch.from_numpy(tvec),
        torch.from_numpy(intr), (960, 480), method="normal").numpy()
    assert got.shape == want.shape == (p38.shape[1], 38, 3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[0, 0], np.zeros(3, np.float32))
    seen = (np.asarray(port_geo.observation_mask(torch.from_numpy(p38))).sum(0) >= 2)
    np.testing.assert_array_equal(got[~seen], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_triangulate_rejects_other_methods():
    # "normal", "svd" and "eigh" are the JAX package's methods, all ported
    with pytest.raises(ValueError, match="unknown triangulate method"):
        port_geo.triangulate(torch.zeros(7, 1, 38, 2), torch.zeros(7, 3, 3),
                             torch.zeros(7, 3), torch.zeros(7, 3, 3), (960, 480),
                             method="qr")


@pytest.fixture(scope="module")
def reprojection_case(golden_calib):
    """Golden 2D points, their float32 DLT points and seeded lens distortion."""
    golden, calib = golden_calib
    R, tvec, intr, _ = jax_geo.calib_to_arrays(calib, 7, dtype=np.float32)
    p38 = np.asarray(golden["points2d"], np.float32)
    pts3d = np.asarray(jax_geo.triangulate(
        jnp.asarray(p38), jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr),
        (960, 480), method="normal"))
    rng = np.random.default_rng(7)
    # scaled to the near-telecentric rig (normalized coords ~0.02): several pixels
    dist = (rng.normal(size=(7, 5)) * [50.0, 1e4, 0.05, 0.05, 1e6]).astype(np.float32)
    return p38, pts3d, R, tvec, intr, dist


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_project_with_distortion_matches_jax(reprojection_case):
    _, pts3d, R, tvec, intr, dist = reprojection_case
    want = np.asarray(jax.vmap(lambda r, t, k, d: jax_geo.project(jnp.asarray(pts3d), r, t, k, d))(
        jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr), jnp.asarray(dist)))
    got = port_geo.project(*_t(np.broadcast_to(pts3d, (7,) + pts3d.shape), R, tvec, intr,
                              dist)).numpy()
    assert got.shape == want.shape == (7,) + pts3d.shape[:2] + (2,)
    assert np.abs(want - np.asarray(jax.vmap(
        lambda r, t, k: jax_geo.project(jnp.asarray(pts3d), r, t, k, jnp.zeros(5)))(
        jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr)))).max() > 1.0   # distortion acts
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_reprojection_residuals_and_error_match_jax(reprojection_case):
    p38, pts3d, R, tvec, intr, dist = reprojection_case
    args = (jnp.asarray(pts3d), jnp.asarray(p38), jnp.asarray(R), jnp.asarray(tvec),
            jnp.asarray(intr), jnp.asarray(dist), (960, 480))
    jres, jmask = jax_geo.reprojection_residuals(*args)
    jerr = float(jax_geo.reprojection_error(*args))
    targs = (*_t(pts3d, p38, R, tvec, intr, dist), (960, 480))
    pres, pmask = port_geo.reprojection_residuals(*targs)
    perr = float(port_geo.reprojection_error(*targs))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    jres = np.asarray(jres)
    np.testing.assert_allclose(pres.numpy(), jres, rtol=1e-5, atol=1e-5 * np.abs(jres).max())
    np.testing.assert_allclose(perr, jerr, rtol=1e-5)


# ------------------------------------------------------- float64 geometry


@pytest.mark.parametrize("distorted", [False, True])
def test_triangulate_svd_float64_matches_jax(golden_calib, distorted):
    golden, calib = golden_calib
    R, tvec, intr, dist = jax_geo.calib_to_arrays(calib, 7)
    p38 = np.asarray(golden["points2d"], np.float64)
    if distorted:
        rng = np.random.default_rng(11)
        dist = rng.normal(size=(7, 5)) * [50.0, 1e4, 0.05, 0.05, 1e6]
    args = (R, tvec, intr)
    want = np.asarray(jax_geo.triangulate(jnp.asarray(p38), *map(jnp.asarray, args), (960, 480),
                                          method="svd", distort=jnp.asarray(dist)))
    got = port_geo.triangulate(*_t(p38, *args), (960, 480), method="svd",
                               distort=torch.from_numpy(np.array(dist))).numpy()
    assert got.dtype == np.float64 and got.shape == (15, 38, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("case", ["zero", "tiny", "generic", "large", "near_pi"])
def test_rodrigues_round_trip_matches_jax(case):
    rvec = np.asarray({"zero": [0.0, 0.0, 0.0], "tiny": [1e-13, -2e-13, 0.0],
                       "generic": [0.3, -1.2, 0.7], "large": [2.0, 1.0, -1.5],
                       "near_pi": [0.6 * (np.pi - 1e-9), -0.8 * (np.pi - 1e-9), 0.0]}[case])
    R = port_geo.rodrigues(torch.from_numpy(rvec)).numpy()
    np.testing.assert_allclose(R, np.asarray(jax_geo.rodrigues(jnp.asarray(rvec))),
                               rtol=0, atol=1e-10)
    back = port_geo.inv_rodrigues(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_geo.inv_rodrigues(jnp.asarray(R))),
                               rtol=0, atol=1e-10)
    if case in ("generic", "large"):                   # |rvec| < pi: the round trip
        np.testing.assert_allclose(back, rvec, rtol=0, atol=1e-10)


def test_inv_rodrigues_of_rig_rotations_matches_jax(golden_calib):
    _, calib = golden_calib
    R = jax_geo.calib_to_arrays(calib, 7)[0]
    for c in range(7):
        np.testing.assert_allclose(port_geo.inv_rodrigues(torch.from_numpy(R[c])).numpy(),
                                   np.asarray(jax_geo.inv_rodrigues(jnp.asarray(R[c]))),
                                   rtol=0, atol=1e-10)


def test_undistort_points_matches_jax():
    rng = np.random.default_rng(5)
    xy = rng.normal(size=(3, 50, 2)) * 0.05
    dist = rng.normal(size=(3, 5)) * [0.3, 0.1, 0.01, 0.01, 0.05]
    want = np.stack([np.asarray(jax_geo.undistort_points(jnp.asarray(xy[c]), jnp.asarray(dist[c])))
                     for c in range(3)])
    got = port_geo.undistort_points(*_t(xy, dist)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # the inverse of the distortion, and exactly the identity for zeros
    np.testing.assert_allclose(port_geo.distort_points(torch.from_numpy(got),
                                                       torch.from_numpy(dist)).numpy(), xy,
                               atol=1e-8)
    zero = port_geo.undistort_points(*_t(xy, np.zeros((3, 5))))
    np.testing.assert_array_equal(zero.numpy(), xy)


def test_procrustes_separate_matches_jax(golden_calib):
    from deepfly3d_tpu.ops import procrustes as jax_pr
    from deepfly3d_torch.ops import procrustes as port_pr

    template = os.path.join(REPO, "data")
    tpl = port_pr.load_template_points3d(template)
    np.testing.assert_array_equal(tpl, jax_pr.load_template_points3d(template))
    with open(os.path.join(REPO, "tests", "data", "reference_df3d", "df3d_result_3d.pkl"),
              "rb") as f:
        raw = pickle.load(f)["points3d_wo_procrustes"]
    rng = np.random.default_rng(9)
    for pts in (raw, raw[:8] + rng.normal(size=raw[:8].shape) * 0.01):
        want = jax_pr.procrustes_separate(pts, tpl)
        got = port_pr.procrustes_separate(pts, tpl)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
        np.testing.assert_array_equal(port_pr.normalize_pose_3d(got, rotate=True),
                                      jax_pr.normalize_pose_3d(got, rotate=True))


@pytest.mark.parametrize("indices", [None, [0, 5, 20]])
def test_filter_batch_matches_jax(indices):
    from deepfly3d_tpu.ops import filters as jax_filters
    from deepfly3d_torch.ops import filters as port_filters

    rng = np.random.default_rng(13)
    pts = np.cumsum(rng.normal(size=(40, 38, 3)), axis=0)
    want = jax_filters.filter_batch(pts, filter_indices=indices)
    got = port_filters.filter_batch(pts, filter_indices=indices)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    assert np.abs(got - pts).max() > 0.1              # it does filter
    # and the stateful reference recursion, sample by sample
    ref = jax_filters.OneEuroFilter(100.0, 0.1, 2.0, 1.0)
    one = [ref(pts[t, 3, 1], (t + 1) * 0.1) for t in range(40)]
    np.testing.assert_allclose(port_filters.filter_batch(pts)[:, 3, 1], one, rtol=0, atol=1e-10)
