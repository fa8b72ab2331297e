"""The port's ``lm`` bundle-adjustment solver vs the JAX package's.

Analogues of ``tests/test_bundle_adjust.py::TestLMSolver`` and
``TestHuberRobustLM``, each also held against the JAX solver on the same
float64 inputs: calibration within 1e-4 and points within 1e-5
(``docs/COVERAGE.md`` §2.2).

Where a solve runs on after it has nearly converged (the Huber solve of
the golden problem in its 30 iterations, the synthetic outlier scenes in
their 60), the damping falls to ~1e-15 and the steps follow the round-off
along the free-point gauge: the reference itself moves by ~0.03 in its
camera parameters when its starting points move by one part in 1e15
(``test_huber_golden_is_round_off_sensitive_in_the_reference``).  There the
port is held to JAX at the same tolerances through the first iterations (12
on the golden problem, 10 on the synthetic scenes), and to the final
objective within 1e-6 relative.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfly3d_tpu.core import Core as JaxCore
from deepfly3d_tpu.ops import bundle_adjust as jax_ba
from deepfly3d_tpu.ops import geometry as jax_geo
from deepfly3d_torch.core import Core
from deepfly3d_torch.ops import bundle_adjust as port_ba
from deepfly3d_torch.ops import geometry as port_geo

IMAGE_SHAPE = (960, 480)
CALIB_ATOL, PTS_ATOL = 1e-4, 1e-5


def _calib_diff(a, b):
    return max(float(np.abs(np.asarray(a[c][k]) - np.asarray(b[c][k])).max())
               for c in a for k in ("R", "tvec", "intr", "distort"))


def _golden_problem(golden_2d, calib_prior):
    prior = {cidx: calib_prior[idx] for idx, cidx in enumerate(golden_2d["camera_ordering"])}
    return golden_2d["points2d"], prior


def _solve_both(cams0, pts0, K, dist, obs, mask, **kw):
    want = jax_ba._lm_solve(*(jnp.asarray(a) for a in (cams0, pts0, K, dist, obs, mask)),
                            **kw)
    got = port_ba._lm_solve(*(torch.from_numpy(np.asarray(a, np.float64))
                              for a in (cams0, pts0, K, dist, obs, mask)), **kw)
    return ([np.asarray(want[0]), np.asarray(want[1]), float(want[2]), float(want[3]),
             int(want[4])], [got[0].numpy(), got[1].numpy(), got[2], got[3], got[4]])


def _assert_solves_close(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=CALIB_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(got[2:4], want[2:4], rtol=1e-9)
    assert got[4] == want[4]


@pytest.fixture(scope="module")
def golden_problem(golden_2d_module, calib_prior_module):
    """The golden problem's packed float64 inputs (C, P), (N, 3), ...."""
    p2, prior = _golden_problem(golden_2d_module, calib_prior_module)
    C, R0, t0, K, dist, pts0, obs, mask = port_ba._prepare(p2, prior, IMAGE_SHAPE)
    cams0 = np.stack([port_ba._pack_cam(R0[c], t0[c], K[c], dist[c], False, False)
                      for c in range(C)])
    return cams0, pts0.reshape(-1, 3), K, dist, obs.reshape(C, -1, 2), \
        mask.reshape(C, -1).astype(np.float64)


def test_golden_problem_matches_jax(golden_2d, calib_prior, golden_3d):
    p2, prior = _golden_problem(golden_2d, calib_prior)
    want = jax_ba.bundle_adjust(p2, prior, IMAGE_SHAPE, solver="lm")
    got = port_ba.bundle_adjust(p2, prior, IMAGE_SHAPE, solver="lm")
    assert got.solver == "lm" and got.iterations == want.iterations
    assert got.cost_final < got.cost_initial
    assert _calib_diff(got.calib, want.calib) <= CALIB_ATOL
    np.testing.assert_allclose(got.points3d, want.points3d, atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(got.cost_final, want.cost_final, rtol=1e-9)
    # the JAX test's gauge-free criterion: the golden optimum's reprojection level
    R, t, K, d = (torch.from_numpy(a) for a in port_geo.calib_to_arrays(got.calib, 7))
    err = float(port_geo.reprojection_error(torch.from_numpy(got.points3d),
                                            torch.from_numpy(p2), R, t, K, d, IMAGE_SHAPE))
    R, t, K, d = (torch.from_numpy(a) for a in port_geo.calib_to_arrays(golden_3d, 7))
    err_golden = float(port_geo.reprojection_error(
        torch.from_numpy(golden_3d["points3d_wo_procrustes"]), torch.from_numpy(p2),
        R, t, K, d, IMAGE_SHAPE))
    assert err <= err_golden * 1.05


def test_huber_golden_first_iterations_match_jax(golden_problem):
    want, got = _solve_both(*golden_problem, max_iters=12, huber_delta=5.0)
    assert got[4] == 12
    _assert_solves_close(want, got)


def test_huber_golden_final_objective_matches_jax(golden_problem):
    want, got = _solve_both(*golden_problem, max_iters=30, huber_delta=5.0)
    assert got[4] == want[4] == 30
    assert got[3] < got[2]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_huber_golden_is_round_off_sensitive_in_the_reference(golden_problem):
    """The reference's own quirk: a one-in-1e15 change of the starting points
    moves JAX's 30-iteration Huber result by more than 1e-3 (so no second
    implementation can be held to it at 1e-4)."""
    cams0, pts0, *rest = golden_problem
    a = jax_ba._lm_solve(*(jnp.asarray(x) for x in (cams0, pts0, *rest)), huber_delta=5.0)
    b = jax_ba._lm_solve(*(jnp.asarray(x) for x in (cams0, pts0 * (1 + 1e-15), *rest)),
                         huber_delta=5.0)
    assert float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()) > 1e-3


def _synthetic_rig(seed, C, N, noise=0.0, outlier_frac=0.0):
    """TestLMSolver / TestHuberRobustLM's synthetic scene and perturbed start."""
    rng = np.random.default_rng(seed)
    pts_true = rng.normal(size=(N, 3)) * 0.3
    K = np.tile(np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]]), (C, 1, 1))
    dist = np.zeros((C, 5))
    cams_true, obs = [], np.zeros((C, N, 2))
    for c in range(C):
        rvec = rng.normal(size=3) * 0.1 + np.array([0, 0.4 * c, 0])
        tvec = np.array([0.0, 0.0, 8.0]) + rng.normal(size=3) * 0.05
        cams_true.append(np.concatenate([rvec, tvec]))
        R = np.asarray(jax_geo.rodrigues(jnp.asarray(rvec)))
        obs[c] = np.asarray(jax_geo.project(jnp.asarray(pts_true), jnp.asarray(R),
                                            jnp.asarray(tvec), jnp.asarray(K[c]),
                                            jnp.asarray(dist[c])))
    if noise:
        obs += rng.normal(size=obs.shape) * noise
        n_out = int(outlier_frac * C * N)
        oc, on = rng.integers(0, C, n_out), rng.integers(0, N, n_out)
        obs[oc, on] += rng.normal(size=(n_out, 2)) * 80
    cams0 = np.stack(cams_true) + rng.normal(size=(C, 6)) * 0.01
    pts0 = pts_true + rng.normal(size=(N, 3)) * 0.02
    return np.stack(cams_true), cams0, pts0, K, dist, obs


def test_synthetic_exact_recovery_matches_jax():
    """Exact observations: both drive the cost to ~1e-26 (where the number of
    accepted steps is decided by round-off) at the same parameters."""
    _, cams0, pts0, K, dist, obs = _synthetic_rig(0, 4, 50)
    want, got = _solve_both(cams0, pts0, K, dist, obs, np.ones(obs.shape[:2]), max_iters=40)
    assert got[3] < 1e-10 * max(got[2], 1.0) and want[3] < 1e-10 * max(want[2], 1.0)
    np.testing.assert_allclose(got[0], want[0], atol=CALIB_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=PTS_ATOL, rtol=0)


@pytest.mark.parametrize("huber", [0.0, 2.0, 5.0])
def test_huber_against_outliers_matches_jax(huber):
    _, cams0, pts0, K, dist, obs = _synthetic_rig(0, 4, 80, noise=0.5, outlier_frac=0.1)
    args = (cams0, pts0, K, dist, obs, np.ones(obs.shape[:2]))
    _assert_solves_close(*_solve_both(*args, max_iters=10, huber_delta=huber))
    want, got = _solve_both(*args, max_iters=60, huber_delta=huber)
    assert got[3] < got[2]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_huber_resists_outliers():
    """Plain least squares is dragged by 80 px outliers; Huber stays near the truth."""
    cams_true, cams0, pts0, K, dist, obs = _synthetic_rig(0, 4, 80, noise=0.5,
                                                          outlier_frac=0.1)
    args = [torch.from_numpy(a) for a in (cams0, pts0, K, dist, obs, np.ones(obs.shape[:2]))]
    err = {h: float(np.abs(port_ba._lm_solve(*args, max_iters=60, huber_delta=h)[0].numpy()
                           - cams_true).max()) for h in (0.0, 2.0)}
    assert err[2.0] < err[0.0] / 3 and err[2.0] < 0.08, err
    clean = _synthetic_rig(0, 4, 80, noise=0.5)
    args = [torch.from_numpy(a) for a in clean[1:] + (np.ones(clean[-1].shape[:2]),)]
    err = [float(np.abs(port_ba._lm_solve(*args, max_iters=60, huber_delta=h)[0].numpy()
                        - clean[0]).max()) for h in (0.0, 5.0)]
    assert abs(err[1] - err[0]) < 5e-3, err


def _intrinsics_problem():
    """A prior with wrong focal lengths, principal points and no distortion
    for a rig with distortion (test_bundle_adjust.py's scene)."""
    rng = np.random.default_rng(3)
    C, T, J = 4, 6, 8
    pts_true = rng.normal(size=(T, J, 3)) * 0.3
    W, H = 1000, 1000
    K_true = np.stack([np.asarray([[900.0 + 30 * c, 0, 480.0 + 5 * c],
                                   [0, 880.0 + 25 * c, 510.0 - 4 * c], [0, 0, 1]])
                       for c in range(C)])
    d_true = np.zeros((C, 5))
    d_true[:, 0], d_true[:, 1] = -0.1, 0.02
    obs, prior = np.zeros((C, T, J, 2)), {}
    for c in range(C):
        R = np.asarray(jax_geo.rodrigues(jnp.asarray([0.05, np.pi / 2 * c, -0.03])))
        tvec = np.asarray([0.0, 0.0, 6.0]) + rng.normal(size=3) * 0.02
        px = np.asarray(jax_geo.project(jnp.asarray(pts_true.reshape(-1, 3)), jnp.asarray(R),
                                        jnp.asarray(tvec), jnp.asarray(K_true[c]),
                                        jnp.asarray(d_true[c]))).reshape(T, J, 2)
        obs[c, ..., 0], obs[c, ..., 1] = px[..., 1] / H, px[..., 0] / W
        K_bad = K_true[c].copy()
        K_bad[0, 0] *= 1.03
        K_bad[1, 1] *= 0.97
        K_bad[0, 2] += 6.0
        K_bad[1, 2] -= 5.0
        prior[c] = {"R": R, "tvec": tvec, "intr": K_bad, "distort": np.zeros(5)}
    return obs, prior, (W, H)


def test_intrinsic_and_distortion_refinement_matches_jax():
    obs, prior, shape = _intrinsics_problem()
    kw = dict(update_intrinsic=True, update_distort=True, solver="lm", max_iters=60)
    want = jax_ba.bundle_adjust(obs, prior, shape, **kw)
    got = port_ba.bundle_adjust(obs, prior, shape, **kw)
    assert got.cost_final < 1e-6 * got.cost_initial
    R, t, K, d = (torch.from_numpy(a) for a in port_geo.calib_to_arrays(got.calib, 4))
    err = float(port_geo.reprojection_error(torch.from_numpy(got.points3d),
                                            torch.from_numpy(obs), R, t, K, d, shape))
    assert err < 1e-4
    assert got.iterations == want.iterations
    for c in range(4):
        for key in ("R", "tvec", "distort"):
            np.testing.assert_allclose(got.calib[c][key], want.calib[c][key],
                                       atol=CALIB_ATOL, rtol=0)
        # focal lengths and principal points are pixels: 1e-4 relative
        np.testing.assert_allclose(got.calib[c]["intr"], want.calib[c]["intr"], rtol=1e-4,
                                   atol=CALIB_ATOL)
    np.testing.assert_allclose(got.points3d, want.points3d, atol=PTS_ATOL, rtol=0)


def test_cam_param_packing_round_trips():
    rng = np.random.default_rng(4)
    R = port_geo.rodrigues(torch.tensor([0.2, -0.4, 0.1], dtype=torch.float64)).numpy()
    K = np.array([[900.0, 0.5, 480.0], [0, 880.0, 510.0], [0, 0, 1]])
    d = rng.normal(size=5) * 0.01
    for ui, ud in ((False, False), (True, False), (False, True), (True, True)):
        vec = port_ba._pack_cam(R, [0.1, 0.2, 6.0], K, d, ui, ud)
        assert vec.shape == (port_ba.cam_param_size(ui, ud),)
        np.testing.assert_allclose(vec, jax_ba._pack_cam(R, np.array([0.1, 0.2, 6.0]), K, d,
                                                         ui, ud), atol=1e-15)
        rvec, tvec, K_u, d_u = port_ba._unpack_cam(torch.from_numpy(vec), torch.from_numpy(K),
                                                   torch.zeros(5, dtype=torch.float64), ui, ud)
        np.testing.assert_allclose(port_geo.rodrigues(rvec).numpy(), R, atol=1e-15)
        np.testing.assert_allclose(K_u.numpy(), K, atol=0)
        np.testing.assert_allclose(d_u.numpy(), d if ud else 0.0, atol=0)


def test_project_one_and_its_jacobians_match_jax():
    rng = np.random.default_rng(5)
    cam = np.concatenate([rng.normal(size=3) * 0.3, [0.1, -0.2, 7.0], [900.0, 880.0, 480.0,
                                                                      510.0],
                          rng.normal(size=5) * 0.02])
    K = np.array([[1.0, 0.3, 0.0], [0.0, 1.0, 0.0], [0, 0, 1]])
    point = rng.normal(size=3) * 0.5
    import jax

    j_args = (jnp.asarray(cam), jnp.asarray(K), jnp.zeros(5), jnp.asarray(point), True, True)
    p_args = (torch.from_numpy(cam), torch.from_numpy(K), torch.zeros(5, dtype=torch.float64),
              torch.from_numpy(point), True, True)
    np.testing.assert_allclose(port_ba._project_one(*p_args).numpy(),
                               np.asarray(jax_ba._project_one(*j_args)), rtol=1e-13)
    for argnum in (0, 3):
        want = jax.jacfwd(jax_ba._project_one, argnums=argnum)(*j_args)
        got = torch.func.jacfwd(port_ba._project_one, argnums=argnum)(*p_args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-9)


def test_parity_solver_modes_point_at_lm(golden_2d, calib_prior):
    p2, prior = _golden_problem(golden_2d, calib_prior)
    with pytest.raises(NotImplementedError, match="solver='lm'"):
        port_ba.bundle_adjust(p2, prior, IMAGE_SHAPE, update_intrinsic=True)
    distorted = {c: dict(v, distort=np.full(5, 1e-3)) for c, v in prior.items()
                 if isinstance(c, (int, np.integer))}
    with pytest.raises(NotImplementedError, match="solver='lm'"):
        port_ba.bundle_adjust(p2, distorted, IMAGE_SHAPE)
    with pytest.raises(ValueError, match="unknown solver"):
        port_ba.bundle_adjust(p2, prior, IMAGE_SHAPE, solver="gn")


def test_core_lm_calibration_chain_matches_jax(working_images, golden_2d):
    """Core.calibrate_calc(solver="lm") on golden 2D, then save: the pickle's
    calibration and 3D points against the JAX Core's."""
    saved = []
    for cls, kw in ((JaxCore, {}), (Core, {"device": "cpu"})):
        core = cls(input_folder=working_images, output_folder=working_images + f"_{len(saved)}",
                   num_images_max=0, camera_ordering=list(range(7)), **kw)
        core.points2d, core.conf = golden_2d["points2d"], golden_2d["heatmap_confidence"]
        result = core.calibrate_calc(0, 100, solver="lm")
        assert result.solver == "lm"
        core.save()
        with open(core.save_path, "rb") as f:
            saved.append(pickle.load(f))
    want, got = saved
    assert _calib_diff({c: got[c] for c in range(7)}, {c: want[c] for c in range(7)}) \
        <= CALIB_ATOL
    for key in ("points3d_wo_procrustes", "points3d"):
        np.testing.assert_allclose(got[key], want[key], atol=PTS_ATOL, rtol=0)
