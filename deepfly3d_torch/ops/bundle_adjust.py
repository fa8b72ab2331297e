"""Sparse bundle adjustment of the camera extrinsics: the ``parity`` and ``lm`` solvers.

Counterpart of ``deepfly3d_tpu/ops/bundle_adjust.py``.  Both solvers share
one problem: observations from (C, T, J, 2) normalized (row, col) points,
3D points started from a float64 SVD triangulation through the calibration
prior.

``solver="parity"``: the reference's optimizer, reverse-engineered from the
golden artifacts.  Observations are ordered camera-major, the parameters
are per-camera (rvec, tvec) followed by the flat points, and scipy's
``least_squares(method="trf", x_scale="jac", ftol=1e-4)`` runs with a
2-point block-sparse Jacobian.  Free-point bundle adjustment has a 7-DoF
gauge null space, so reaching the golden calibration (1e-4) means taking the
same optimizer path: scipy on the host, float64, as in the JAX package.

``solver="lm"``: Schur-complement Levenberg-Marquardt on dense masked
residual grids, with optional intrinsics (fx, fy, cx, cy), 5-coefficient
distortion and Huber IRLS (``huber_px``).  The per-observation Jacobians are
``torch.func.jacfwd`` of ``_project_one`` under ``torch.func.vmap``; the
point blocks are eliminated analytically (3x3 blocks), leaving a dense
(P*C, P*C) camera system.  The JAX package's ``lax.while_loop`` is a Python
loop with the same condition.  Float64 on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

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
            "use solver='lm' for intrinsic or distortion refinement")
    C, R0, t0, K, dist, pts0, obs, mask = _prepare(points2d_rowcol, calib_prior, image_shape)
    if np.any(dist != 0):
        raise NotImplementedError(
            "the parity solver replicates the reference's pinhole residual (the fly "
            "rig has distort == 0); use solver='lm', whose residual model applies "
            "the full 5-coefficient distortion")
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


# ================================================================== LM solver


def cam_param_size(update_intrinsic: bool, update_distort: bool) -> int:
    """Per-camera parameter count: rvec(3) + tvec(3) [+ fx, fy, cx, cy] [+ 5]."""
    return 6 + (4 if update_intrinsic else 0) + (5 if update_distort else 0)


def _unpack_cam(cam_vec, K0, dist0, update_intrinsic: bool, update_distort: bool):
    """cam_vec (P,) -> (rvec, tvec, K, dist); the optimized blocks override the
    fixed K0 / dist0 (the skew stays fixed: it is no OpenCV parameter)."""
    rvec, tvec = cam_vec[:3], cam_vec[3:6]
    off = 6
    K, dist = K0, dist0
    if update_intrinsic:
        fx, fy, cx, cy = (cam_vec[off + i] for i in range(4))
        zero, one = torch.zeros_like(fx), torch.ones_like(fx)
        K = torch.stack([torch.stack([fx, K0[0, 1], cx]), torch.stack([zero, fy, cy]),
                         torch.stack([zero, zero, one])])
        off += 4
    if update_distort:
        dist = cam_vec[off:off + 5]
    return rvec, tvec, K, dist


def _pack_cam(R, tvec, K, dist, update_intrinsic: bool, update_distort: bool) -> np.ndarray:
    """Inverse of ``_unpack_cam`` for the initial parameter vector (numpy float64)."""
    parts = [geometry.inv_rodrigues(torch.from_numpy(np.asarray(R, np.float64))).numpy(),
             np.asarray(tvec)]
    if update_intrinsic:
        parts.append(np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    if update_distort:
        parts.append(np.asarray(dist))
    return np.concatenate(parts)


def _project_one(cam_vec, K, dist, point, update_intrinsic: bool = False,
                 update_distort: bool = False):
    """Pixel (x, y) of one 3D point in one camera; cam_vec per ``cam_param_size``."""
    rvec, tvec, K, dist = _unpack_cam(cam_vec, K, dist, update_intrinsic, update_distort)
    Xc = geometry.rodrigues(rvec) @ point + tvec
    xy = geometry.distort_points((Xc[:2] / Xc[2])[None], dist[None])[0]
    return torch.stack([K[0, 0] * xy[0] + K[0, 1] * xy[1] + K[0, 2],
                        K[1, 1] * xy[1] + K[1, 2]])


def _per_observation(fn, cams, pts, K, dist):
    """``fn(cam_vec, K, dist, point)`` over every (camera, point): cams (..., C,
    P), pts (..., N, 3), K (..., C, 3, 3), dist (..., C, 5) -> (..., C, N,
    ...).  Leading axes are independent members, each camera against its own
    member's points; a member gets the bits of its own unbatched call."""
    if cams.dim() > 2:
        return vmap(lambda c, p, K_, d_: _per_observation(fn, c, p, K_, d_))(cams, pts, K, dist)
    return vmap(lambda c, K_, d_: vmap(lambda p: fn(c, K_, d_, p))(pts))(cams, K, dist)


def _residual_grid(cams, pts, K, dist, obs, mask, update_intrinsic=False,
                   update_distort=False):
    """(..., C, P), (..., N, 3) -> masked residuals (..., C, N, 2)."""
    proj = _per_observation(
        lambda c, K_, d_, p: _project_one(c, K_, d_, p, update_intrinsic, update_distort),
        cams, pts, K, dist)
    return (proj - obs) * mask[..., None]


def _cost(cams, pts, K, dist, obs, mask, update_intrinsic=False, update_distort=False,
          huber_delta: float = 0.0) -> torch.Tensor:
    """0.5 * sum(r^2), or the Huber objective on each observation's 2-norm
    (quadratic inside ``huber_delta``, linear outside)."""
    return _objective(_residual_grid(cams, pts, K, dist, obs, mask, update_intrinsic,
                                     update_distort), huber_delta)


def _objective(r, huber_delta: float = 0.0) -> torch.Tensor:
    """The objective of residuals r (..., C, N, 2), summed over (C, N): 0.5 *
    sum(r^2), or with ``huber_delta`` the Huber function of each
    observation's 2-norm."""
    if huber_delta and huber_delta > 0:
        s = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-30)        # (..., C, N)
        rho = torch.where(s <= huber_delta, 0.5 * s * s,
                          huber_delta * (s - 0.5 * huber_delta))
        return torch.sum(rho, dim=(-2, -1))
    return 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


def _damped_step(r, jc, jp, mask, lam, huber_delta: float = 0.0):
    """One damped Gauss-Newton step with the points eliminated (Schur complement).

    r (..., C, N, 2) residuals, jc (..., C, N, 2, P) and jp (..., C, N, 2, 3)
    Jacobians, mask (..., C, N); ``lam`` a float, or one damping per leading
    index.  Any leading axes are independent problems.  -> (delta_c (..., C,
    P), delta_p (..., N, 3)).
    """
    C, P = jc.shape[-4], jc.shape[-1]
    dtype, dev = jc.dtype, jc.device
    if isinstance(lam, torch.Tensor):
        lam = lam.reshape(lam.shape + (1, 1, 1))
    m = mask[..., None, None]
    jc, jp = jc * m, jp * m
    if huber_delta and huber_delta > 0:
        # masked observations have r == 0: weight 1, harmless
        s = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-30)
        sw = torch.sqrt(torch.where(s > huber_delta, huber_delta / s, 1.0))
        r = r * sw[..., None]
        jc = jc * sw[..., None, None]
        jp = jp * sw[..., None, None]
    eyeP = torch.eye(P, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    diag = torch.arange(C, device=dev)
    # normal-equation blocks
    U = torch.einsum("...cnri,...cnrj->...cij", jc, jc)                # (C, P, P)
    V = torch.einsum("...cnri,...cnrj->...nij", jp, jp)                # (N, 3, 3)
    W = torch.einsum("...cnri,...cnrj->...cnij", jc, jp)               # (C, N, P, 3)
    g_c = torch.einsum("...cnri,...cnr->...ci", jc, r)                 # (C, P)
    g_p = torch.einsum("...cnri,...cnr->...ni", jp, r)                 # (N, 3)
    # Marquardt damping of the block diagonals, and a tiny absolute floor
    # for blocks no observation reaches
    U = U + lam * (U * eyeP)
    V = V + lam * (V * eye3) + 1e-12 * eye3
    U = U + 1e-12 * eyeP
    V_inv = torch.linalg.inv(V)
    WVi = torch.einsum("...cnij,...njk->...cnik", W, V_inv)            # (C, N, P, 3)
    S = -torch.einsum("...cnik,...dnjk->...cdij", WVi, W)              # (C, C, P, P)
    S[..., diag, diag, :, :] += U
    lead = S.shape[:-4]
    S = S.transpose(-3, -2).reshape(lead + (C * P, C * P))
    rhs = (g_c - torch.einsum("...cnik,...nk->...ci", WVi, g_p)).reshape(lead + (C * P,))
    delta_c = torch.linalg.solve(S, -rhs).reshape(lead + (C, P))
    delta_p = torch.einsum("...nij,...nj->...ni", V_inv,
                           -(g_p + torch.einsum("...cnij,...ci->...nj", W, delta_c)))
    return delta_c, delta_p


def _lm_solve(cams0, pts0, K, dist, obs, mask, max_iters: int = 30,
              update_intrinsic: bool = False, update_distort: bool = False,
              huber_delta: float = 0.0):
    """Schur-complement Levenberg-Marquardt.

    cams0 (C, P) with P = ``cam_param_size(...)``, pts0 (N, 3), K (C, 3, 3),
    dist (C, 5), obs (C, N, 2), mask (C, N) float.  Returns (cams, pts, cost0,
    cost, iters).  ``huber_delta`` (pixels, 0 = plain least squares) weights
    each observation's residual and Jacobians by sqrt(min(1, delta / |r|))
    in every step (IRLS), and a step is accepted on the true Huber objective.
    """
    flags = (update_intrinsic, update_distort)
    jac = jacfwd(lambda c, K_, d_, p: _project_one(c, K_, d_, p, *flags), argnums=(0, 3))

    def step(cams, pts, lam):
        r = _residual_grid(cams, pts, K, dist, obs, mask, *flags)      # (C, N, 2)
        jc, jp = _per_observation(jac, cams, pts, K, dist)              # (C, N, 2, P|3)
        delta_c, delta_p = _damped_step(r, jc, jp, mask, lam, huber_delta)
        return cams + delta_c, pts + delta_p

    def cost_of(cams, pts):
        return float(_cost(cams, pts, K, dist, obs, mask, *flags, huber_delta=huber_delta))

    cams, pts = cams0, pts0
    cost0 = cost = cost_of(cams, pts)
    lam, it, done = 1e-4, 0, False
    while not done and it < max_iters and lam < 1e10:
        new_cams, new_pts = step(cams, pts, lam)
        new_cost = cost_of(new_cams, new_pts)
        accept = new_cost < cost
        rel_drop = (cost - new_cost) / max(cost, 1e-30)
        if accept:
            cams, pts, cost = new_cams, new_pts, new_cost
        lam = lam * 0.3 if accept else lam * 4.0
        done = accept and rel_drop < 1e-10
        it += 1
    return cams, pts, cost0, cost, it


def _lm_solve_batched(cams0, pts0, K, dist, obs, mask, max_iters: int = 30,
                      update_intrinsic: bool = False, update_distort: bool = False,
                      huber_delta: float = 0.0):
    """B independent ``_lm_solve``s in one batched solve on the inputs' device.

    cams0 (B, C, P), pts0 (B, N, 3), K (B, C, 3, 3), dist (B, C, 5), obs
    (B, C, N, 2), mask (B, C, N).  Returns (cams, pts, cost0 (B,), cost (B,),
    iters (B,)), each member what its own ``_lm_solve`` returns (up to the
    order of the sums): what ``jax.vmap`` of the JAX ``lax.while_loop``
    computes.  Every member steps while any runs; a member whose own
    condition has ended (converged, ``max_iters`` or the damping at 1e10)
    keeps its state, its damping and its iteration count.  One host read per
    iteration: whether any member still runs.
    """
    B = cams0.shape[0]
    dtype, dev = cams0.dtype, cams0.device
    flags = (update_intrinsic, update_distort)
    jac = jacfwd(lambda c, K_, d_, p: _project_one(c, K_, d_, p, *flags), argnums=(0, 3))

    def cost_of(cams, pts):
        return _cost(cams, pts, K, dist, obs, mask, *flags, huber_delta=huber_delta)

    cams, pts = cams0, pts0
    cost0 = cost = cost_of(cams, pts)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        running = ~done & (it < max_iters) & (lam < 1e10)
        if not bool(running.any()):
            break
        r = _residual_grid(cams, pts, K, dist, obs, mask, *flags)      # (B, C, N, 2)
        jc, jp = _per_observation(jac, cams, pts, K, dist)              # (B, C, N, 2, P|3)
        delta_c, delta_p = _damped_step(r, jc, jp, mask, lam, huber_delta)
        new_cams, new_pts = cams + delta_c, pts + delta_p
        new_cost = cost_of(new_cams, new_pts)
        accept = new_cost < cost
        rel_drop = (cost - new_cost) / cost.clamp_min(1e-30)
        take = running & accept
        cams = torch.where(take[:, None, None], new_cams, cams)
        pts = torch.where(take[:, None, None], new_pts, pts)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(running, torch.where(accept, lam * 0.3, lam * 4.0), lam)
        done = torch.where(running, accept & (rel_drop < 1e-10), done)
        it = it + running.to(it.dtype)
    return cams, pts, cost0, cost, it


def _bundle_adjust_lm(points2d_rowcol, calib_prior, image_shape, update_intrinsic,
                      update_distort, max_iters: int = 30,
                      huber_px: float = 0.0) -> BundleAdjustResult:
    C, R0, t0, K, dist, pts0, obs, mask = _prepare(points2d_rowcol, calib_prior, image_shape)
    T, J = pts0.shape[:2]
    cams0 = torch.from_numpy(np.stack([
        _pack_cam(R0[c], t0[c], K[c], dist[c], update_intrinsic, update_distort)
        for c in range(C)]))
    K_t, dist_t = torch.from_numpy(K), torch.from_numpy(dist)
    with torch.no_grad():
        cams, pts, cost0, cost, iters = _lm_solve(
            cams0, torch.from_numpy(pts0.reshape(-1, 3)), K_t, dist_t,
            torch.from_numpy(obs.reshape(C, -1, 2)),
            torch.from_numpy(mask.reshape(C, -1).astype(np.float64)),
            max_iters=max_iters, update_intrinsic=update_intrinsic,
            update_distort=update_distort, huber_delta=float(huber_px))
        R_out, K_out, d_out = [], [], []
        for c in range(C):
            rvec, _, K_c, d_c = _unpack_cam(cams[c], K_t[c], dist_t[c], update_intrinsic,
                                            update_distort)
            R_out.append(geometry.rodrigues(rvec).numpy())
            K_out.append(K_c.numpy())
            d_out.append(d_c.numpy())
    cams = cams.numpy()
    return BundleAdjustResult(
        calib=geometry.arrays_to_calib(np.stack(R_out), cams[:, 3:6], np.stack(K_out),
                                       np.stack(d_out)),
        points3d=pts.numpy().reshape(T, J, 3),
        cost_initial=cost0,
        cost_final=cost,
        iterations=iters,
        solver="lm",
    )


# ===================================================================== public


def bundle_adjust(points2d_rowcol: np.ndarray, calib_prior: Dict[int, dict],
                  image_shape: Tuple[int, int], update_intrinsic: bool = False,
                  update_distort: bool = False, solver: str = "parity",
                  **kwargs) -> BundleAdjustResult:
    """Refine camera extrinsics (and 3D points) from (C, T, J, 2) normalized
    (row, col) observations; zeros and col == 1 are unobserved.

    ``solver="lm"`` takes ``max_iters`` and ``huber_px`` (the Huber scale in
    pixels; 0 is plain least squares, the reference's behaviour); the parity
    solver takes no options.
    """
    if solver == "parity":
        return _bundle_adjust_parity(points2d_rowcol, calib_prior, image_shape,
                                     update_intrinsic, update_distort)
    if solver == "lm":
        return _bundle_adjust_lm(points2d_rowcol, calib_prior, image_shape,
                                 update_intrinsic, update_distort, **kwargs)
    raise ValueError(f"unknown solver {solver!r}")
