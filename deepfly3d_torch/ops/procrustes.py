"""Procrustes registration of the triangulated pose onto a template skeleton.

Counterpart of ``deepfly3d_tpu/ops/procrustes.py`` (the reference's
per-side chain, df3d/procrustes.py:51-151), in float64 on the host:

1. per-side scale from the median bone lengths of the three 5-keypoint legs;
2. median-centre the side, apply the scale;
3. rigid (no scaling) orthogonal alignment of the time-median
   BODY_COXA / COXA_FEMUR anchors onto the template's (an SVD);
4. apply the rotation and translation to every frame.

Medians are numpy's: the mean of the two middle values for an even count
(``torch.median`` would take the lower one).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch


def load_template_points3d(path: str) -> np.ndarray:
    """Template pose (T, J, 3) from a df3d_result pickle, or the first
    ``df3d_result*.pkl`` in a directory."""
    if os.path.isfile(path):
        file = path
    else:
        matches = sorted(glob.glob(os.path.join(path, "df3d_result*.pkl")))
        if not matches:
            raise FileNotFoundError(f"No df3d_result*.pkl under {path}")
        file = matches[0]
    with open(file, "rb") as f:
        d = pickle.load(f)
    pts3d = d["points3d"]
    assert pts3d is not None
    return np.asarray(pts3d)


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's median along ``dim``: the mean of the middle two for even counts."""
    s, n = torch.sort(x, dim=dim).values, x.shape[dim]
    lo, hi = s.narrow(dim, (n - 1) // 2, 1), s.narrow(dim, n // 2, 1)
    return ((lo + hi) / 2.0).squeeze(dim)


def _leg_bone_lengths(pts: torch.Tensor, n_legs: int = 3, leg_len: int = 5) -> torch.Tensor:
    """(T, J, 3) -> (T, n_legs * (leg_len - 1)) adjacent-segment lengths."""
    legs = pts[:, : n_legs * leg_len].reshape(pts.shape[0], n_legs, leg_len, 3)
    seg = torch.linalg.vector_norm(legs[:, :, 1:] - legs[:, :, :-1], dim=-1)
    return seg.reshape(pts.shape[0], -1)


def _orthogonal_align(X: torch.Tensor, Y: torch.Tensor):
    """Rigid alignment without scaling: (T_rot, c) with Y @ T_rot + c closest to X."""
    muX, muY = X.mean(dim=0), Y.mean(dim=0)
    X0, Y0 = X - muX, Y - muY
    A = (X0 / torch.sqrt((X0 ** 2).sum())).T @ (Y0 / torch.sqrt((Y0 ** 2).sum()))
    U, _, Vt = torch.linalg.svd(A, full_matrices=False)
    T_rot = Vt.T @ U.T
    return T_rot, muX - muY @ T_rot


def procrustes_side(pts: torch.Tensor, template: torch.Tensor, anchor_idx: Sequence[int],
                    n_legs: int = 3, leg_len: int = 5) -> torch.Tensor:
    """Align one body side (T, J_side, 3) onto its template."""
    ratio = (_median(_leg_bone_lengths(template, n_legs, leg_len), 0)
             / _median(_leg_bone_lengths(pts, n_legs, leg_len), 0))
    s = _median(ratio, 0)
    pts = (pts - _median(pts.reshape(-1, 3), 0)) * s
    anchors = list(anchor_idx)
    T_rot, c = _orthogonal_align(_median(template[:, anchors], 0), _median(pts[:, anchors], 0))
    return pts @ T_rot + c


def procrustes_separate(pts: np.ndarray, template: np.ndarray,
                        anchor_idx: Optional[Sequence[int]] = None,
                        side_joints: int = 19) -> np.ndarray:
    """Per-side Procrustes of (T, 2 * side_joints, 3) onto the template, float64.

    ``anchor_idx`` defaults to the BODY_COXA / COXA_FEMUR joints of each side's
    three legs.
    """
    if anchor_idx is None:
        anchor_idx = [0, 1, 5, 6, 10, 11]
    p = torch.as_tensor(np.asarray(pts, np.float64))
    t = torch.as_tensor(np.asarray(template, np.float64))
    sides = [procrustes_side(p[:, lo:lo + side_joints], t[:, lo:lo + side_joints], anchor_idx)
             for lo in (0, side_joints)]
    return torch.cat(sides, dim=1).numpy()


def rotate_points3d(pts: np.ndarray) -> np.ndarray:
    """Axis shuffle for plotting: (x, y, z) -> (x, -z, -y)."""
    pts = np.asarray(pts)
    return np.stack([pts[..., 0], -pts[..., 2], -pts[..., 1]], axis=-1)


def normalize_pose_3d(pts: np.ndarray, normalize_median: bool = True,
                      rotate: bool = False) -> np.ndarray:
    """Median-centre over all points, and optionally rotate the axes; returns a copy."""
    pts = np.array(pts)
    if normalize_median:
        pts = pts - np.median(pts.reshape(-1, 3), axis=0)
    if rotate:
        pts = rotate_points3d(pts)
    return pts
