"""The ``pipeline`` entry's comparison: the 2D->3D call's outputs against the reference.

Every call of the window is judged against the reference's call on the same
chunk (``reference/pipeline.run``).  Four numbers, each the worst over all
calls:

* ``conf_err``: the largest |conf - reference conf|, the heatmap maxima.
* ``cell_gap``: for every 2D point that differs from the reference's, the
  cell that the program chose is read back from the point (the
  registration's shift taken off, a right-side column mirrored back), and
  the gap is how far the reference's heatmap there lies below its maximum.
  A point that is not on the heatmap's grid, or that differs where the
  assembly holds a constant, reads infinity.  Near-ties, whose gap is
  rounding, read near 0; a wrong cell reads the heatmap's own contrast.
* ``p3d_err``: the program's canonical points (its 2D output with the
  reference's registration shift taken off) triangulated by the reference's
  float64 DLT, against the program's 3D output: the largest distance over
  the reference point's norm (or the median norm, where that is larger).
  Compared are the points that fewer than two cameras see (both zero) and
  those whose null vector is determined: the second-smallest singular value
  of their equations at least ``SEPARATION`` times the smallest.  Below
  that, as for the inconsistent 2D points of a seeded net, two sound
  solvers give different points of about the same residual (the program's
  DLT is four inverse-power steps on its normal equations).
* ``p3d_resid``: the weaker check that holds every point seen by two
  cameras or more, those that ``p3d_err`` leaves out among them: how far
  the DLT residual of the program's 3D point lies above the least that
  the equations of its canonical 2D points allow, over the gap to the
  next singular value (``reference/pipeline.residual_excess``).  0 at the
  reference's solution, rounding at a determined point, below about 1
  for any point of an undetermined point's flat direction; a zeroed or
  foreign point reads many times that.

An output that holds NaN, or has another shape, reads infinity everywhere.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from reference import pipeline as ref

NAMES = ("conf_err", "cell_gap", "p3d_err", "p3d_resid")
SEPARATION = 4.0


def _defined(order: np.ndarray, C: int, J: int):
    """(C, J) masks of the entries that carry a cell: the left cameras'
    joints 0-18 and the right cameras' 19-37, less those the assembly drops."""
    K = J // 2
    cam, joint = np.arange(C)[:, None], np.arange(J)[None, :]
    left = np.isin(cam, order[:3]) & (joint < K) & ~((cam == order[2]) & (joint >= 15))
    right = np.isin(cam, order[4:]) & (joint >= K) & ~((cam == order[4]) & (joint >= K + 15))
    return left, right


def _cell_gap(p38, canon, r: ref.Result, order) -> Tuple[float, int]:
    """-> (the worst gap over the points that differ from the reference's, their count)."""
    C, T, J, _ = p38.shape
    K = J // 2
    hm = r.heatmaps
    h, w = hm.shape[2:]
    c, t, j = np.nonzero(np.abs(p38 - r.points2d).max(axis=-1) > 1e-6)
    if not len(c):
        return 0.0, 0
    left, right = _defined(order, C, J)
    mirrored = right[c, j]
    row = canon[c, t, j, 0] * h
    col = np.where(mirrored, 1.0 - canon[c, t, j, 1], canon[c, t, j, 1]) * w
    ri, ci = np.rint(row), np.rint(col)
    bad = ~(left[c, j] | mirrored) | (np.abs(row - ri) > 1e-3) | (np.abs(col - ci) > 1e-3) \
        | (ri < 0) | (ri >= h) | (ci < 0) | (ci >= w)
    index = [torch.as_tensor(a, device=hm.device) for a in
             (t * C + c, np.where(mirrored, j - K, j),
              np.clip(ri, 0, h - 1).astype(np.int64), np.clip(ci, 0, w - 1).astype(np.int64))]
    at = hm[index[0], index[1], index[2], index[3]].double().cpu().numpy()
    top = hm.flatten(2).max(dim=-1).values[index[0], index[1]].double().cpu().numpy()
    return float(np.where(bad, np.inf, top - at).max()), len(c)


def judge_call(out: Sequence[np.ndarray], r: ref.Result, rig: ref.Rig,
               image_hw) -> Dict[str, float]:
    """One call's outputs (points3d, points2d38, conf) against the reference's
    result on its chunk: -> {name: number, "mismatched": points that differ,
    "seen": points seen by two cameras or more, "determined": those of them
    that ``p3d_err`` judges}."""
    p3d, p38, conf = (np.asarray(a, np.float64) for a in out)
    if (p38.shape, conf.shape, p3d.shape) != (r.points2d.shape, r.conf.shape, r.points3d.shape) \
            or not all(np.isfinite(a).all() for a in (p3d, p38, conf)):
        return {**{n: np.inf for n in NAMES}, "mismatched": -1, "seen": 0, "determined": 0}
    off = ref.offsets(r.dy, r.dx, image_hw).astype(np.float64)
    canon = p38 - ref.observed(p38)[..., None] * off[:, None, None, :]
    gap, mismatched = _cell_gap(p38, canon, r, np.asarray(rig.order))
    tri, separation = ref.triangulate(canon, rig, image_hw)
    norm = np.linalg.norm(tri, axis=-1)
    scale = np.maximum(norm, max(float(np.median(norm[norm > 0])) if (norm > 0).any() else 1.0,
                                 1e-12))
    judged = separation >= SEPARATION
    p3d_err = float((np.linalg.norm(p3d - tri, axis=-1) / scale)[judged].max(initial=0.0))
    seen = np.isfinite(separation)
    resid = ref.residual_excess(canon, p3d, rig, image_hw)
    return {"conf_err": float(np.abs(conf - r.conf).max()), "cell_gap": gap,
            "p3d_err": p3d_err, "p3d_resid": float(resid.max(initial=0.0)),
            "mismatched": mismatched, "seen": int(seen.sum()),
            "determined": int((seen & judged).sum())}
