"""3D skeleton figures (matplotlib, Agg): a copy of ``deepfly3d_tpu/viz/plot3d.py``.

Behavioural match of reference df3d/plot_util.py:20-82 and video.py:128-164:
dark-background 3D axes, per-camera azimuth, stripe-joint midpointing,
per-limb colours and z-orders.  matplotlib is imported when a frame is
rendered, not with the module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked

IMG3D_DPI = 100
IMG3D_ASPECT = (2, 2)


def plot_skeleton_3d(
    ax3d,
    points3d: np.ndarray,
    skeleton: Skeleton,
    cam_id: int,
    lim: Optional[float] = None,
    thickness: Optional[np.ndarray] = None,
):
    """Draw one frame's skeleton into an existing 3D axes."""
    pts = np.array(points3d)
    J = skeleton.num_joints
    colors = ["#%02x%02x%02x" % tuple(c) for c in skeleton.joint_colors_rgb()]
    zorder = skeleton.get_zorder(cam_id)
    if thickness is None:
        thickness = np.ones(skeleton.num_limbs) * 1.5

    white = (1.0, 1.0, 1.0, 0.0)
    ax3d.xaxis.set_pane_color(white)
    ax3d.yaxis.set_pane_color(white)
    ax3d.xaxis.line.set_color(white)
    ax3d.yaxis.line.set_color(white)
    ax3d.zaxis.line.set_color(white)

    # per-camera viewpoint (reference plot_util.py:49-52)
    if cam_id < 3:
        ax3d.view_init(elev=ax3d.elev, azim=-60 + 30 * cam_id)
    else:
        ax3d.view_init(elev=ax3d.elev, azim=-60 + 45 * cam_id)

    if lim:
        ax3d.set_xlim(-lim, lim)
        ax3d.set_ylim(-lim, lim)
        ax3d.set_zlim(-lim, lim)

    # fly: average the two sides' stripe points (reference plot_util.py:63-71)
    if skeleton.name == "fly":
        half = J // 2
        for j in range(half):
            if skeleton.tracked_points[j] == Tracked.STRIPE:
                mid = (pts[j] + pts[j + half]) / 2
                pts[j] = mid
                pts[j + half] = mid

    for j0, j1 in skeleton.bones:
        ax3d.plot(
            pts[[j0, j1], 0],
            pts[[j0, j1], 1],
            pts[[j0, j1], 2],
            c=colors[j0],
            linewidth=thickness[skeleton.get_limb_id(j0)],
            zorder=zorder[j0],
        )


def render_frame_3d(
    points3d_frame: np.ndarray,
    skeleton: Skeleton,
    cam_id: int,
    lim: float = 2.0,
) -> np.ndarray:
    """Rasterize one 3D frame to an RGB uint8 array (reference video.py:128-164)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    plt.style.use("dark_background")
    try:
        plt.rcParams["axes3d.automargin"] = True
    except KeyError:
        pass
    fig = plt.figure(figsize=IMG3D_ASPECT, dpi=IMG3D_DPI)
    ax3d = fig.add_subplot(111, projection="3d")
    fig.tight_layout(pad=0)
    for axis_set in (ax3d.set_xticks, ax3d.set_yticks, ax3d.set_zticks):
        axis_set([])
    ax3d.set_xticklabels([])
    ax3d.set_yticklabels([])
    ax3d.set_zticklabels([])

    plot_skeleton_3d(
        ax3d,
        points3d_frame,
        skeleton,
        cam_id=cam_id,
        lim=lim,
        thickness=np.ones(skeleton.num_limbs) * 1.5,
    )
    fig.canvas.draw()
    data = np.array(fig.canvas.renderer.buffer_rgba(), dtype=np.uint8)[:, :, :3]
    plt.close(fig)
    return data
