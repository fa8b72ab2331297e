"""2D pose overlays (cv2): a copy of ``deepfly3d_tpu/viz/plot2d.py``.

Replaces pyba's ``Camera.plot_2d`` (used via reference df3d/core.py:317-319):
bones and joints drawn over the camera image, skipping unobserved points
(zeros, and the flip artifact on the far edge) and joints the camera cannot
see.  The drawing calls are the JAX package's, so the pixels are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from deepfly3d_torch.skeletons.skeleton import Skeleton


def _valid_point(pt: np.ndarray, width: int, height: int) -> bool:
    x, y = float(pt[0]), float(pt[1])
    if x <= 0 and y <= 0:
        return False
    # the reference flip artifact lands on the far edge (col == 1.0)
    if x >= width - 0.5 and y <= 0:
        return False
    return 0 <= x < width + 1 and 0 <= y < height + 1


# pyba's joint and bone style, as the JAX package fit it against the
# reference's shipped golden video: filled navy circles r=8 (anti-aliased)
# over LINE_8 bone lines of thickness 5, drawn at the raw (unsmoothed) points.
MARKER_COLOR = (0, 0, 128)     # RGB navy


def draw_pose2d(
    image: np.ndarray,
    points_xy: np.ndarray,
    skeleton: Skeleton,
    cam_id: int,
    joints: Sequence[int] = (),
    line_thickness: int = 5,
    scatter_r: int = 8,
    marker: str = "circle",
    marker_color: Optional[Sequence[int]] = MARKER_COLOR,
) -> np.ndarray:
    """Draw the skeleton over ``image`` (H, W, 3) at pixel (x, y) points.

    ``marker``: "circle" (pyba's filled navy dot, the reference-video
    look — in the joint's bone color when ``marker_color`` is None) or
    "square" (an open square).  Bone lines are
    LINE_8 (no AA), markers anti-aliased — both measured off the
    reference's shipped golden video.
    """
    import cv2

    out = np.ascontiguousarray(image.copy())
    h, w = out.shape[:2]
    joint_set = set(joints) if joints else None
    colors = skeleton.joint_colors_rgb()
    zorder = skeleton.get_zorder(cam_id)

    # draw bones back-to-front following the per-camera z-order
    bone_order = sorted(
        range(len(skeleton.bones)), key=lambda b: -zorder[skeleton.bones[b][0]]
    )
    for b in bone_order:
        j0, j1 = skeleton.bones[b]
        if joint_set is not None and (j0 not in joint_set or j1 not in joint_set):
            continue
        if not (
            skeleton.camera_see_joint(cam_id, j0)
            and skeleton.camera_see_joint(cam_id, j1)
        ):
            continue
        p0, p1 = points_xy[j0], points_xy[j1]
        if not (_valid_point(p0, w, h) and _valid_point(p1, w, h)):
            continue
        cv2.line(
            out,
            (int(round(p0[0])), int(round(p0[1]))),
            (int(round(p1[0])), int(round(p1[1]))),
            tuple(int(c) for c in colors[j0]),
            line_thickness,
            lineType=cv2.LINE_8,
        )

    for j in range(skeleton.num_joints):
        if joint_set is not None and j not in joint_set:
            continue
        if not skeleton.camera_see_joint(cam_id, j):
            continue
        p = points_xy[j]
        if not _valid_point(p, w, h):
            continue
        x, y = int(round(p[0])), int(round(p[1]))
        color = tuple(
            int(c) for c in (marker_color if marker_color is not None
                             else colors[j])
        )
        if marker == "square":
            cv2.rectangle(
                out, (x - scatter_r, y - scatter_r),
                (x + scatter_r, y + scatter_r), color, 3,
                lineType=cv2.LINE_AA,
            )
        else:
            cv2.circle(out, (x, y), scatter_r, color, -1, lineType=cv2.LINE_AA)
    return out
