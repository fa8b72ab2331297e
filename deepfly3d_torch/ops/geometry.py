"""Multi-view geometry: masked DLT triangulation, projection, rotations.

Counterpart of ``deepfly3d_tpu/ops/geometry.py``.  Two triangulation paths:

* ``method="normal"`` (float32, the golden pipeline and the cascade on the
  card): column-preconditioned normal equations solved in closed form;
* ``method="svd"`` (float64, ``Core``, bundle adjustment): the last right
  singular vector of each point's DLT matrix, batched through
  ``torch.linalg.svd``, with optional undistortion of the observations.

Also here: ``observation_mask``, ``rowcol_to_pixel_xy``,
``projection_matrices``, ``distort_points`` / ``undistort_points``,
``project``, ``reprojection_residuals``, ``reprojection_error`` (dtype
follows the inputs: float64 for ``Core``), ``rodrigues`` /
``inv_rodrigues`` and ``calib_to_arrays`` / ``arrays_to_calib``.  The JAX
package vmaps one-point and one-camera functions; here each batch dimension
is written out.  As in the JAX package, the float64 geometry runs on the
host CPU whatever device the network runs on.

Conventions: stored points are normalized (row, col); the observation plane
is pixel (x, y) = (col * W, row * H); a point is observed iff row != 0,
col != 0 and col != 1 (zeros mean unseen, col == 1 is the flip artifact).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def observation_mask(points2d_rowcol: torch.Tensor) -> torch.Tensor:
    """(..., 2) normalized (row, col) -> bool mask of real observations."""
    row, col = points2d_rowcol[..., 0], points2d_rowcol[..., 1]
    return (row != 0) & (col != 0) & (col != 1)


def rowcol_to_pixel_xy(points2d_rowcol: torch.Tensor,
                       image_shape: Tuple[int, int]) -> torch.Tensor:
    """Normalized (row, col) -> pixel (x, y); ``image_shape`` is (width, height)."""
    width, height = image_shape
    return torch.stack([points2d_rowcol[..., 1] * width,
                        points2d_rowcol[..., 0] * height], dim=-1)


def projection_matrices(R: torch.Tensor, tvec: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(C,3,3), (C,3), (C,3,3) -> (C,3,4) P = K [R | t]."""
    return intr @ torch.cat([R, tvec[..., None]], dim=-1)


def _dlt_normal(obs_xy: torch.Tensor, P: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked homogeneous DLT of B points, the JAX ``method="normal"`` path.

    obs_xy (B, C, 2) pixels, P (C, 3, 4), mask (B, C) -> (B, 3); zeros where
    fewer than two cameras see the point.  Column-preconditioned normal
    equations solved in closed form (Cramer), refined by four inverse-power
    iterations on the 4x4 normal matrix via its Schur complement.
    """
    dt = obs_xy.dtype
    m = mask[..., None].to(dt)
    rows_x = (obs_xy[..., 0:1] * P[None, :, 2, :] - P[None, :, 0, :]) * m
    rows_y = (obs_xy[..., 1:2] * P[None, :, 2, :] - P[None, :, 1, :]) * m
    A = torch.cat([rows_x, rows_y], dim=1)                    # (B, 2C, 4)
    s = torch.sqrt(torch.sum(A * A, dim=1)) + 1e-30           # (B, 4)
    An = A / s[:, None, :]
    M = An[..., :3]
    a3 = An[..., 3]
    AtA = M.transpose(1, 2) @ M + 1e-6 * torch.eye(3, dtype=dt, device=A.device)
    Atb = torch.einsum("bri,br->bi", M, -a3)
    a = AtA
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c02 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c10 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c20 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c21 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c10 + a[:, 0, 2] * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    Binv = adj / det[:, None, None]                           # (B, 3, 3)

    def mv(mat, v):
        return (mat @ v[..., None])[..., 0]

    y = mv(Binv, Atb)
    cvec = torch.einsum("bri,br->bi", M, a3)
    d = torch.sum(a3 * a3, dim=1)
    Bi_c = mv(Binv, cvec)
    schur = d - torch.sum(cvec * Bi_c, dim=1)

    s3, s4 = s[:, :3], s[:, 3]
    seed = y * (s4[:, None] / s3)
    x1, x2 = seed, torch.ones_like(s4)
    for _ in range(4):
        u1, u2 = x1 / s3, x2 / s4
        Bi_u1 = mv(Binv, u1)
        w2 = (u2 - torch.sum(cvec * Bi_u1, dim=1)) / schur
        w1 = Bi_u1 - Bi_c * w2[:, None]
        nx1, nx2 = w1 / s3, w2 / s4
        nrm = torch.sqrt(torch.sum(nx1 * nx1, dim=1) + nx2 * nx2) + 1e-30
        x1, x2 = nx1 / nrm[:, None], nx2 / nrm
    refined = x1 / x2[:, None]
    finite = torch.isfinite(refined).all(dim=1, keepdim=True)
    point = torch.where(finite, refined, seed)
    valid = (mask.sum(dim=1) >= 2)[:, None]
    return torch.where(valid, point, torch.zeros_like(point))


def _dlt_svd(obs_xy: torch.Tensor, P: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked homogeneous DLT of B points, the JAX ``method="svd"`` path.

    obs_xy (B, C, 2) pixels, P (C, 3, 4), mask (B, C) -> (B, 3): the right
    singular vector of the smallest singular value of each (2C, 4) matrix
    (x rows, then y rows; unseen cameras' rows zeroed) over its w; zeros
    where fewer than two cameras see the point.
    """
    m = mask[..., None].to(obs_xy.dtype)
    rows_x = (obs_xy[..., 0:1] * P[None, :, 2, :] - P[None, :, 0, :]) * m
    rows_y = (obs_xy[..., 1:2] * P[None, :, 2, :] - P[None, :, 1, :]) * m
    A = torch.cat([rows_x, rows_y], dim=1)                    # (B, 2C, 4)
    X = torch.linalg.svd(A, full_matrices=True).Vh[:, -1]     # (B, 4)
    point = X[:, :3] / X[:, 3:]
    valid = (mask.sum(dim=1) >= 2)[:, None]
    return torch.where(valid, point, torch.zeros_like(point))


def triangulate(points2d_rowcol: torch.Tensor, R: torch.Tensor, tvec: torch.Tensor,
                intr: torch.Tensor, image_shape: Tuple[int, int],
                method: str = "normal", distort: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DLT-triangulate every (frame, joint): (C, T, J, 2) -> (T, J, 3).

    Zeros where fewer than two cameras see the joint.  ``method``: "normal"
    (closed form, the float32 pipelines) or "svd" (run it in float64 for the
    reference's 1e-5).  ``distort``: optional (C, 5) OpenCV coefficients;
    the pixel observations are undistorted first (identity for zeros).  The
    JAX "eigh" method is not ported.
    """
    if method not in ("normal", "svd"):
        raise NotImplementedError(f"triangulate method {method!r}: 'normal' and 'svd' "
                                  "are ported (ROADMAP.md Queue 1 item 3)")
    C, T, J, _ = points2d_rowcol.shape
    P = projection_matrices(R, tvec, intr)
    obs = rowcol_to_pixel_xy(points2d_rowcol, image_shape)
    mask = observation_mask(points2d_rowcol)
    if distort is not None:
        obs = _undistort_pixels(obs, intr, distort)
    obs_flat = obs.reshape(C, T * J, 2).transpose(0, 1)     # (TJ, C, 2)
    mask_flat = mask.reshape(C, T * J).T                    # (TJ, C)
    dlt = _dlt_normal if method == "normal" else _dlt_svd
    return dlt(obs_flat, P, mask_flat).reshape(T, J, 3)


def distort_points(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """OpenCV 5-coefficient distortion of normalized coords.

    ``xy`` (C, ..., 2) and ``dist`` (C, 5): camera c's coefficients apply to
    ``xy[c]``.
    """
    shape = (dist.shape[0],) + (1,) * (xy.dim() - 2)
    k1, k2, p1, p2, k3 = (dist[:, i].reshape(shape) for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_t = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + x_t, y * radial + y_t], dim=-1)


def undistort_points(xy_dist: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Inverse of ``distort_points``: ``xy_dist`` (C, ..., 2), ``dist`` (C, 5).

    The OpenCV fixed-point scheme, ``x <- (x_dist - tangential(x)) /
    radial(x)`` for ``iters`` steps; exactly the identity for zero
    coefficients (the fly rig has none).
    """
    shape = (dist.shape[0],) + (1,) * (xy_dist.dim() - 2)
    k1, k2, p1, p2, k3 = (dist[:, i].reshape(shape) for i in range(5))
    xd, yd = xy_dist[..., 0], xy_dist[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def _undistort_pixels(uv: torch.Tensor, intr: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Distorted pixels (C, ..., 2) -> ideal-pinhole pixels, camera c by
    ``intr[c]`` and ``dist[c]`` (the JAX ``_undistort_pixels``, vmapped there)."""
    shape = (intr.shape[0],) + (1,) * (uv.dim() - 2)
    fx, gamma, cx = (intr[:, 0, i].reshape(shape) for i in range(3))
    fy, cy = intr[:, 1, 1].reshape(shape), intr[:, 1, 2].reshape(shape)
    yn = (uv[..., 1] - cy) / fy
    xn = (uv[..., 0] - cx - gamma * yn) / fx
    xy = undistort_points(torch.stack([xn, yn], dim=-1), dist)
    return torch.stack([fx * xy[..., 0] + gamma * xy[..., 1] + cx,
                        fy * xy[..., 1] + cy], dim=-1)


def project(points3d: torch.Tensor, R: torch.Tensor, tvec: torch.Tensor,
            intr: torch.Tensor, distort: torch.Tensor) -> torch.Tensor:
    """World points (C, ..., 3) -> pixel (x, y) (C, ..., 2), camera c projecting ``points3d[c]``.

    R (C, 3, 3), tvec (C, 3), intr (C, 3, 3), distort (C, 5).  The JAX
    ``project`` is one camera; its vmap over cameras is the leading C here.
    """
    C = R.shape[0]
    shape = (C,) + (1,) * (points3d.dim() - 2)
    pts = points3d.reshape(C, -1, 3)
    Xc = (pts @ R.transpose(1, 2) + tvec[:, None, :]).reshape(points3d.shape)
    xy = distort_points(Xc[..., :2] / Xc[..., 2:3], distort)
    fx, gamma, cx = (intr[:, 0, i].reshape(shape) for i in range(3))
    fy, cy = intr[:, 1, 1].reshape(shape), intr[:, 1, 2].reshape(shape)
    u = fx * xy[..., 0] + gamma * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def reprojection_residuals(points3d: torch.Tensor, points2d_rowcol: torch.Tensor,
                           R: torch.Tensor, tvec: torch.Tensor, intr: torch.Tensor,
                           distort: torch.Tensor, image_shape: Tuple[int, int]):
    """Per-observation pixel residuals of (T, J, 3) points against (C, T, J, 2).

    Returns (res, mask): res (C, T, J, 2) = projected - observed in pixel
    (x, y), zero where unobserved; mask (C, T, J) of real observations.
    """
    C = R.shape[0]
    proj = project(points3d.expand((C,) + tuple(points3d.shape)), R, tvec, intr, distort)
    obs = rowcol_to_pixel_xy(points2d_rowcol, image_shape)
    mask = observation_mask(points2d_rowcol)
    return (proj - obs) * mask[..., None].to(proj.dtype), mask


def reprojection_error(points3d: torch.Tensor, points2d_rowcol: torch.Tensor,
                       R: torch.Tensor, tvec: torch.Tensor, intr: torch.Tensor,
                       distort: torch.Tensor, image_shape: Tuple[int, int]) -> torch.Tensor:
    """Mean L2 pixel reprojection error over the real observations (0-dim)."""
    res, mask = reprojection_residuals(points3d, points2d_rowcol, R, tvec, intr,
                                       distort, image_shape)
    norms = torch.linalg.vector_norm(res, dim=-1)
    return norms.sum() / mask.sum().clamp_min(1)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3, 3); the identity at theta < 1e-12.

    No Python branch on the data, as in the JAX function (a guarded
    ``1 / theta`` and a ``where``), so that it runs under ``torch.func.vmap``
    and ``jacfwd`` (the lm bundle adjustment's Jacobians).
    """
    theta = torch.linalg.vector_norm(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    small = theta < 1e-12
    k = rvec / torch.where(small, torch.ones_like(theta), theta)
    zero = torch.zeros_like(theta)
    K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                     torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye, R)


def inv_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3) -> axis-angle (3,), with the theta = pi and
    theta = 0 cases of the JAX function."""
    cos_t = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    axis_raw = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_t = 0.5 * torch.linalg.vector_norm(axis_raw)
    theta = torch.atan2(sin_t, cos_t)
    if theta < 1e-12:
        return torch.zeros(3, dtype=R.dtype, device=R.device)
    if torch.abs(sin_t) >= 1e-6:
        return axis_raw / (2.0 * sin_t) * theta
    # near pi the off-diagonal differences vanish: the axis from diag((R + I) / 2)
    axis = torch.sqrt(torch.clamp((torch.diagonal(R) + 1.0) / 2.0, min=0.0))
    one = torch.ones((), dtype=R.dtype, device=R.device)
    signs = torch.stack([one, torch.where(R[0, 1] + R[1, 0] >= 0, one, -one),
                         torch.where(R[0, 2] + R[2, 0] >= 0, one, -one)])
    return axis * signs * theta


def calib_to_arrays(calib: Dict[int, dict], num_cameras: int, dtype=np.float64):
    """Dict-of-dicts calib -> stacked (C,3,3), (C,3), (C,3,3), (C,5) numpy arrays."""
    def stack(key):
        return np.stack([np.asarray(calib[c][key], dtype=dtype) for c in range(num_cameras)])

    return stack("R"), stack("tvec"), stack("intr"), stack("distort")


def arrays_to_calib(R, tvec, intr, distort) -> Dict[int, dict]:
    """Stacked per-camera arrays -> {cam: {R, tvec, distort, intr}} of numpy arrays."""
    R, tvec, intr, distort = (np.asarray(a) for a in (R, tvec, intr, distort))
    return {c: {"R": R[c], "tvec": tvec[c], "distort": distort[c], "intr": intr[c]}
            for c in range(R.shape[0])}
