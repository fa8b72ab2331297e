"""Sparse bundle adjustment of the camera extrinsics, the ``parity`` solver.

Counterpart of ``deepfly3d_tpu/ops/bundle_adjust.py`` (``solver="parity"``):
the reference's optimizer, reverse-engineered from the golden artifacts.
Observations are ordered camera-major, 3D points start from a float64 SVD
triangulation through the calibration prior, the parameters are per-camera
(rvec, tvec) followed by the flat points, and scipy's
``least_squares(method="trf", x_scale="jac", ftol=1e-4)`` runs with a
2-point block-sparse Jacobian.  Free-point bundle adjustment has a 7-DoF
gauge null space, so reaching the golden calibration (1e-4) means taking the
same optimizer path: scipy on the host, float64, as in the JAX package.

The batched Levenberg-Marquardt ``solver="lm"`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from deepfly3d_torch.ops import geometry


@dataclasses.dataclass
class BundleAdjustResult:
    calib: Dict[int, dict]           # refined {cam: {R, tvec, intr, distort}}
    points3d: np.ndarray             # refined 3D points (T, J, 3)
    cost_initial: float              # 0.5 * sum(residual^2)
    cost_final: float
    iterations: int
    solver: str


def _prepare(points2d_rowcol: np.ndarray, calib_prior: Dict[int, dict], image_shape):
    """-> (C, R0, t0, K, dist, DLT points (T, J, 3), pixel obs (C, T, J, 2),
    mask (C, T, J)), numpy float64."""
    C = len([k for k in calib_prior if isinstance(k, (int, np.integer))])
    R0, t0, K, dist = geometry.calib_to_arrays(calib_prior, C)
    p2 = torch.as_tensor(np.asarray(points2d_rowcol, np.float64))
    R0_t, t0_t, K_t, dist_t = (torch.from_numpy(a) for a in (R0, t0, K, dist))
    pts0 = geometry.triangulate(p2, R0_t, t0_t, K_t, image_shape, method="svd",
                                distort=dist_t)
    obs = geometry.rowcol_to_pixel_xy(p2, image_shape).numpy()
    mask = geometry.observation_mask(p2).numpy()
    return C, R0, t0, K, dist, pts0.numpy(), obs, mask


def _bundle_adjust_parity(points2d_rowcol, calib_prior, image_shape, update_intrinsic,
                          update_distort) -> BundleAdjustResult:
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    if update_intrinsic or update_distort:
        raise NotImplementedError(
            "the parity solver replicates the reference's extrinsics-only mode; "
            "intrinsic refinement needs the lm solver (ROADMAP.md Queue 1 item 10)")
    C, R0, t0, K, dist, pts0, obs, mask = _prepare(points2d_rowcol, calib_prior, image_shape)
    if np.any(dist != 0):
        raise NotImplementedError(
            "the parity solver replicates the reference's pinhole residual (the fly "
            "rig has distort == 0); distortion needs the lm solver (ROADMAP.md "
            "Queue 1 item 10)")
    T, J = pts0.shape[:2]
    n_pts = T * J

    # camera-major observation list
    cam_idx, pt_idx, obs_list = [], [], []
    for c in range(C):
        tt, jj = np.nonzero(mask[c])
        cam_idx.append(np.full(tt.shape, c))
        pt_idx.append(tt * J + jj)
        obs_list.append(obs[c][tt, jj])
    cam_idx = np.concatenate(cam_idx)
    pt_idx = np.concatenate(pt_idx)
    obs_arr = np.concatenate(obs_list)
    n_obs = len(obs_arr)

    def rot(rvec) -> np.ndarray:
        return geometry.rodrigues(torch.from_numpy(np.array(rvec, np.float64))).numpy()

    rvecs0 = np.stack([geometry.inv_rodrigues(torch.from_numpy(R0[c])).numpy()
                       for c in range(C)])
    x0 = np.concatenate([np.concatenate([rvecs0, t0], axis=1).ravel(), pts0.ravel()])
    sel_by_cam = [cam_idx == c for c in range(C)]

    def residuals(x):
        cams = x[: C * 6].reshape(C, 6)
        pts = x[C * 6:].reshape(n_pts, 3)
        out = np.empty((n_obs, 2))
        for c in range(C):
            sel = sel_by_cam[c]
            if not sel.any():
                continue
            Xc = pts[pt_idx[sel]] @ rot(cams[c, :3]).T + cams[c, 3:]
            xy = Xc[:, :2] / Xc[:, 2:3]
            out[sel, 0] = K[c][0, 0] * xy[:, 0] + K[c][0, 2]
            out[sel, 1] = K[c][1, 1] * xy[:, 1] + K[c][1, 2]
        return (out - obs_arr).ravel()

    sparsity = lil_matrix((n_obs * 2, len(x0)), dtype=int)
    rows = np.arange(n_obs)
    for s in range(6):
        sparsity[2 * rows, cam_idx * 6 + s] = 1
        sparsity[2 * rows + 1, cam_idx * 6 + s] = 1
    for s in range(3):
        sparsity[2 * rows, C * 6 + pt_idx * 3 + s] = 1
        sparsity[2 * rows + 1, C * 6 + pt_idx * 3 + s] = 1

    r0 = residuals(x0)
    res = least_squares(residuals, x0, jac_sparsity=sparsity, x_scale="jac", ftol=1e-4,
                        method="trf")
    cams = res.x[: C * 6].reshape(C, 6)
    R_out = np.stack([rot(cams[c, :3]) for c in range(C)])
    return BundleAdjustResult(
        calib=geometry.arrays_to_calib(R_out, cams[:, 3:], K, dist),
        points3d=res.x[C * 6:].reshape(T, J, 3),
        cost_initial=0.5 * float(r0 @ r0),
        cost_final=float(res.cost),
        iterations=int(res.nfev),
        solver="parity",
    )


def bundle_adjust(points2d_rowcol: np.ndarray, calib_prior: Dict[int, dict],
                  image_shape: Tuple[int, int], update_intrinsic: bool = False,
                  update_distort: bool = False, solver: str = "parity",
                  **kwargs) -> BundleAdjustResult:
    """Refine camera extrinsics (and 3D points) from (C, T, J, 2) normalized
    (row, col) observations; zeros and col == 1 are unobserved.

    Only ``solver="parity"`` is ported; ``"lm"`` raises NotImplementedError.
    """
    if solver == "parity":       # takes no options (``kwargs`` are the lm solver's)
        return _bundle_adjust_parity(points2d_rowcol, calib_prior, image_shape,
                                     update_intrinsic, update_distort)
    if solver == "lm":
        raise NotImplementedError("the lm bundle-adjustment solver is not ported yet "
                                  "(ROADMAP.md Queue 1 item 10)")
    raise ValueError(f"unknown solver {solver!r}")
