"""Rasterised 3D skeleton (cv2, no matplotlib): a copy of ``deepfly3d_tpu/viz/raster3d.py``.

The reference draws its 3D video row with a fresh matplotlib figure per
(frame, camera) (reference df3d/video.py:128-164).  This renderer draws the
same view directly: the orthographic look-at of matplotlib's ``view_init``
(azimuth and elevation), painter's-algorithm bone order by the skeleton's
per-camera z-orders, and anti-aliased cv2 lines on a dark canvas, with the
semantics of ``viz/plot3d.py`` (per-camera azimuth, stripe midpointing,
per-limb colours).  The pixel-golden videos under ``tests/data/golden_videos``
pin its output; ``make_pose3d_video(renderer="matplotlib")`` keeps the
figure path.
"""

from __future__ import annotations

import numpy as np

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked

RASTER3D_SIZE = (200, 200)  # (w, h) — matches plot3d's 2x2 in @ 100 dpi


def _view_basis(azim_deg: float, elev_deg: float) -> np.ndarray:
    """Screen-plane basis of matplotlib's (azim, elev) orthographic view.

    Returns (2, 3): rows are the world-space directions of screen +x and
    screen +y (up).  The viewer looks along -view_dir toward the origin.
    """
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    # screen right: perpendicular to the view azimuth, in the xy plane
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    # screen up: tilt of the z axis under elevation
    up = np.array(
        [-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)]
    )
    return np.stack([right, up])


def camera_azimuth(cam_id: int) -> float:
    """Per-camera azimuth of the reference's 3D row
    (reference plot_util.py:49-52)."""
    if cam_id < 3:
        return -60.0 + 30.0 * cam_id
    return -60.0 + 45.0 * cam_id


def render_frame_3d_fast(
    points3d_frame: np.ndarray,
    skeleton: Skeleton,
    cam_id: int,
    lim: float = 2.0,
    size=RASTER3D_SIZE,
    elev: float = 30.0,
) -> np.ndarray:
    """One frame's skeleton -> RGB uint8 (h, w, 3) on a dark background."""
    import cv2

    w, h = size
    pts = np.array(points3d_frame, dtype=np.float64)
    J = skeleton.num_joints

    # fly: average the two sides' stripe points (reference plot_util.py:63-71)
    if skeleton.name == "fly":
        half = J // 2
        for j in range(half):
            if skeleton.tracked_points[j] == Tracked.STRIPE:
                mid = (pts[j] + pts[j + half]) / 2
                pts[j] = mid
                pts[j + half] = mid

    basis = _view_basis(camera_azimuth(cam_id), elev)
    proj = pts @ basis.T  # (J, 2) screen coords in world units

    # map [-lim, lim] -> pixels with a small margin, y up -> row down
    margin = 0.08
    scale = (1.0 - 2 * margin) * min(w, h) / (2.0 * lim)
    px = (proj[:, 0] * scale + w / 2.0)
    py = (h / 2.0 - proj[:, 1] * scale)
    pix = np.stack([px, py], axis=1)

    canvas = np.zeros((h, w, 3), dtype=np.uint8)
    colors = skeleton.joint_colors_rgb()
    zorder = skeleton.get_zorder(cam_id)

    # painter's algorithm: draw low z-order first (reference zorder
    # semantics: higher get_zorder value draws on top)
    order = sorted(range(len(skeleton.bones)),
                   key=lambda b: zorder[skeleton.bones[b][0]])
    for b in order:
        j0, j1 = skeleton.bones[b]
        p0 = pix[j0]
        p1 = pix[j1]
        if not (np.isfinite(p0).all() and np.isfinite(p1).all()):
            continue
        color = tuple(int(c) for c in colors[j0])
        cv2.line(
            canvas,
            (int(round(p0[0])), int(round(p0[1]))),
            (int(round(p1[0])), int(round(p1[1]))),
            color,
            thickness=2,
            lineType=cv2.LINE_AA,
        )
    return canvas
