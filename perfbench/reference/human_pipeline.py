"""The human 2D->3D call written out plainly: what the benchmark holds the
program's h36m profile to.

One chunk of T frames of C cameras, (T, C, H, W, 3) uint8 (Human3.6M's
layout: 4 cameras of 1000x1000, lens distortion), goes through

1. /255 and PyTorch's antialiased bilinear resize to the network's input,
   no camera flipped;
2. the stacked hourglass (``hourglass.py``; a checkpoint in the flax
   layout), the last stack's heatmaps;
3. per heatmap and joint the first maximal cell, (row / h, col / w), and
   the maximum as the confidence;
4. the observed points' pixels, (col * W, row * H), undistorted by
   OpenCV's fixed-point scheme in float64;
5. the homogeneous DLT of every joint seen by two cameras or more, the
   null vector of its stacked equations by a float64 SVD (zero for the
   others).

Departures from the published description, each the program's convention:
no registration (a human rig has no template, and Human3.6M's cameras do
not drift); a point is observed where row != 0, col != 0 and col != 1, the
mask that the fly's assembly needs and the program keeps for every profile
(a joint decoded into the heatmap's first row or column counts as unseen);
the undistortion runs ``ITERATIONS`` steps, to convergence in float64 at
such a rig's distortion, where OpenCV's ``undistortPoints`` stops after 5
and the program after 8; and the calibration is held as the program holds
it, in float32, before the float64 arithmetic.  Every product is float32
with TF32 off unless ``tf32`` is asked for (the control).  Imports nothing
of the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.pipeline import first_max

ITERATIONS = 20
FAR = 1e-6


class Rig(NamedTuple):
    """The calibration the call triangulates with, float64 of float32 values."""

    R: np.ndarray                  # (C, 3, 3)
    tvec: np.ndarray               # (C, 3)
    intr: np.ndarray               # (C, 3, 3)
    distort: np.ndarray            # (C, 5): k1, k2, p1, p2, k3
    input_shape: tuple             # (h, w) of the network input


def ring_calibration(num_cameras: int, size: int, focal: float, distance: float,
                     k1: float) -> Dict[str, np.ndarray]:
    """A ring of cameras 90 degrees apart about the vertical axis through the
    origin, each ``distance`` away looking at it, square ``size`` frames,
    barrel distortion ``k1``: {R, tvec, intr, distort}, stacked, float64."""
    R = []
    for cam in range(num_cameras):
        c, s = np.cos(np.pi / 2 * cam), np.sin(np.pi / 2 * cam)
        R.append([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    intr = np.array([[focal, 0.0, size / 2.0], [0.0, focal, size / 2.0], [0.0, 0.0, 1.0]])
    distort = np.zeros(5)
    distort[0] = k1
    return {"R": np.asarray(R), "tvec": np.tile([0.0, 0.0, distance], (num_cameras, 1)),
            "intr": np.tile(intr, (num_cameras, 1, 1)),
            "distort": np.tile(distort, (num_cameras, 1))}


def load_rig(cfg: Dict) -> Rig:
    """The configuration's rig (its ``rig`` parameters), in float32 as the
    program is given it, then float64."""
    cal = ring_calibration(**cfg["rig"])
    R, tvec, intr, distort = (cal[k].astype(np.float32).astype(np.float64)
                              for k in ("R", "tvec", "intr", "distort"))
    return Rig(R, tvec, intr, distort, tuple(cfg["spec"]["input_shape"]))


def preprocess(frames: torch.Tensor, input_shape) -> torch.Tensor:
    """(T, C, H, W, 3) uint8 -> the network input (T*C, 3, h, w) float32, frames-major."""
    T, C, H, W, _ = frames.shape
    out = []
    for t in range(T):
        x = frames[t].permute(0, 3, 1, 2).float() / 255.0
        out.append(F.interpolate(x, size=tuple(input_shape), mode="bilinear",
                                 align_corners=False, antialias=True))
    return torch.cat(out)


def observed(points2d: np.ndarray) -> np.ndarray:
    """Observations: row != 0, col != 0 and col != 1."""
    return (points2d[..., 0] != 0) & (points2d[..., 1] != 0) & (points2d[..., 1] != 1)


def undistort_pixels(uv: np.ndarray, rig: Rig) -> np.ndarray:
    """Distorted pixels (C, ..., 2) -> ideal-pinhole pixels, float64: the
    normalised coordinates x, y through camera c's intrinsics, then ``x <-
    (x_d - tangential(x, y)) / radial(x, y)`` (OpenCV's scheme), back
    through the intrinsics."""
    shape = (rig.intr.shape[0],) + (1,) * (uv.ndim - 2)
    K = rig.intr.reshape(shape + (3, 3))
    fx, gamma, cx = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    fy, cy = K[..., 1, 1], K[..., 1, 2]
    k1, k2, p1, p2, k3 = (rig.distort[:, i].reshape(shape) for i in range(5))
    yd = (uv[..., 1] - cy) / fy
    xd = (uv[..., 0] - cx - gamma * yd) / fx
    x, y = xd, yd
    for _ in range(ITERATIONS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return np.stack([fx * x + gamma * y + cx, fy * y + cy], axis=-1)


def dlt_equations(points2d: np.ndarray, rig: Rig, image_hw):
    """(C, T, J, 2) normalised (row, col) -> ((T, J, 2C, 4) float64 DLT
    equations of the undistorted observations, x rows then y rows, an
    unseen camera's rows zero; (T, J) mask of the points that two cameras
    or more see)."""
    H, W = image_hw
    P = rig.intr @ np.concatenate([rig.R, rig.tvec[..., None]], axis=-1)
    pix = np.stack([points2d[..., 1].astype(np.float64) * W,
                    points2d[..., 0].astype(np.float64) * H], axis=-1)
    pix = undistort_pixels(pix, rig)
    seen = observed(points2d)
    rows_x = pix[..., 0, None] * P[:, None, None, 2] - P[:, None, None, 0]
    rows_y = pix[..., 1, None] * P[:, None, None, 2] - P[:, None, None, 1]
    A = np.concatenate([rows_x, rows_y], axis=0) * np.concatenate([seen, seen])[..., None]
    return A.transpose(1, 2, 0, 3), seen.sum(axis=0) >= 2


def triangulate(points2d: np.ndarray, rig: Rig, image_hw):
    """(C, T, J, 2) -> ((T, J, 3) float64 points, (T, J) separation): each
    point the null vector of its DLT equations, zero where fewer than two
    cameras see it; the separation is the ratio of the equations'
    second-smallest singular value to the smallest (infinite for an unseen
    point).  A null vector at infinity (|w| < ``FAR`` of the unit vector, a
    point a million times farther than the rig's scale; opposite cameras of
    a ring that see one cell give such points exactly) has no place to
    compare: it is given as the finite point at w = ``FAR`` along it, and
    its separation as 0, so that it is judged by its residual alone."""
    A, valid = dlt_equations(points2d, rig, image_hw)
    _, s, vt = np.linalg.svd(A)
    X = vt[..., -1, :]
    far = np.abs(X[..., 3]) < FAR
    w = np.where(far, np.where(X[..., 3] < 0, -FAR, FAR), X[..., 3])
    with np.errstate(divide="ignore", invalid="ignore"):
        separation = np.where(valid, np.where(far, 0.0, s[..., 2] / s[..., 3]), np.inf)
    return np.where(valid[..., None], X[..., :3] / w[..., None], 0.0), separation


def residual_excess(points2d: np.ndarray, points3d: np.ndarray, rig: Rig,
                    image_hw) -> np.ndarray:
    """(T, J): how far the DLT residual of the given 3D points lies above the
    least that the 2D points' equations allow, over the gap to the
    second-smallest singular value (0 where fewer than two cameras see the
    point); as ``reference/pipeline.residual_excess``, on these equations."""
    A, valid = dlt_equations(points2d, rig, image_hw)
    s = np.linalg.svd(A, compute_uv=False)
    v = np.concatenate([points3d.astype(np.float64), np.ones(points3d.shape[:-1] + (1,))], -1)
    r = np.linalg.norm((A @ v[..., None])[..., 0], axis=-1) / np.linalg.norm(v, axis=-1)
    gap = np.maximum(s[..., 2] - s[..., 3], 1e-12 * s[..., 2] + 1e-300)
    return np.where(valid, (r - s[..., 3]) / gap, 0.0)


class Result(NamedTuple):
    """The reference's call on one chunk, and what judging needs of it."""

    points3d: np.ndarray           # (T, J, 3) float64
    points2d: np.ndarray           # (C, T, J, 2) float32
    conf: np.ndarray               # (C, T, J, 1) float32
    heatmaps: torch.Tensor         # (T*C, J, h, w) float32, on the device


def run(frames: torch.Tensor, net, rig: Rig, image_hw, block: int = 32,
        tf32: bool = False) -> Result:
    """The call on one chunk (T, C, H, W, 3) uint8, the network in blocks of
    ``block`` images."""
    T, C = frames.shape[:2]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            x = preprocess(frames, rig.input_shape)
            hm = torch.cat([net.forward(x[i:i + block]) for i in range(0, len(x), block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    N, K, h, w = hm.shape
    idx = first_max(hm)
    conf = hm.reshape(N, K, h * w).max(dim=-1).values
    rows = (idx // w).cpu().numpy().astype(np.float32) / np.float32(h)
    cols = (idx % w).cpu().numpy().astype(np.float32) / np.float32(w)
    p2d = np.ascontiguousarray(np.stack([rows, cols], -1).reshape(T, C, K, 2).transpose(1, 0, 2, 3))
    conf = conf.cpu().numpy().reshape(T, C, K, 1).transpose(1, 0, 2, 3)
    return Result(triangulate(p2d, rig, image_hw)[0], p2d, np.ascontiguousarray(conf), hm)
