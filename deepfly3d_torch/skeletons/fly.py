"""Drosophila 38-joint skeleton (a copy of ``deepfly3d_tpu/skeletons/fly.py``).

Semantics mirror reference df3d/skeleton_fly.py (joint taxonomy 16-55, limbs
56-95, visibility 97-134/222-249, bones 136-167, colors 169-188, bone priors
252-261, z-orders 282-301) but everything is constructed programmatically
from the 2-sides x (3 legs x 5 keypoints + antenna + 3 stripes) layout and
precomputed into mask arrays.
"""

from __future__ import annotations

import numpy as np

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked

NUM_CAMERAS = 7
LEG_JOINT_ORDER = (
    Tracked.BODY_COXA,
    Tracked.COXA_FEMUR,
    Tracked.FEMUR_TIBIA,
    Tracked.TIBIA_TARSUS,
    Tracked.TARSUS_TIP,
)

# ------------------------------------------------------------------ taxonomy


def _one_side():
    """Joint categories and limb ids for one body side (19 joints, 5 limbs)."""
    tracked, limbs = [], []
    for leg in range(3):                      # front / middle / hind legs
        tracked.extend(LEG_JOINT_ORDER)
        limbs.extend([leg] * 5)
    tracked.append(Tracked.ANTENNA)
    limbs.append(3)
    tracked.extend([Tracked.STRIPE] * 3)
    limbs.extend([4] * 3)
    return tracked, limbs


_side_tracked, _side_limbs = _one_side()
SIDE_JOINTS = len(_side_tracked)              # 19
tracked_points = tuple(_side_tracked + _side_tracked)
limb_id = tuple(_side_limbs + [l + 5 for l in _side_limbs])
num_joints = len(tracked_points)              # 38

# ------------------------------------------------------------------- bones


def _side_bones(offset: int):
    bones = []
    for leg in range(3):
        base = offset + 5 * leg
        bones += [(base + i, base + i + 1) for i in range(4)]
    stripe0 = offset + 16                      # stripes are joints 16..18
    bones += [(stripe0, stripe0 + 1), (stripe0 + 1, stripe0 + 2)]
    return bones


bones = tuple(_side_bones(0) + _side_bones(SIDE_JOINTS))
bones3d = ((15, 34),)                          # antenna-to-antenna, 3D only

# ------------------------------------------------------------------- colors

LEG_RIGHT_FRONT = (186, 30, 49)
LEG_RIGHT_MIDDLE = (201, 86, 79)
LEG_RIGHT_REAR = (213, 133, 121)
LEG_LEFT_FRONT = (15, 115, 153)
LEG_LEFT_MIDDLE = (26, 141, 175)
LEG_LEFT_REAR = (117, 190, 203)
BODY = (210, 210, 210)

limb_colors = (
    LEG_RIGHT_FRONT, LEG_RIGHT_MIDDLE, LEG_RIGHT_REAR, BODY, BODY,
    LEG_LEFT_FRONT, LEG_LEFT_MIDDLE, LEG_LEFT_REAR, BODY, BODY,
)

# --------------------------------------------------------------- visibility


def _visibility_matrix() -> np.ndarray:
    """(7, 38) bool: which camera sees which joint.

    Rules (reference skeleton_fly.py:222-249): cameras 0-2 see the first
    body side, 4-6 the second, camera 3 (middle) sees both sides' legs
    except BODY_COXA/COXA_FEMUR plus antennas; cameras 2 and 4 cannot see
    stripes.
    """
    limb_left = np.array([l < 5 for l in range(10)])
    limb_right = ~limb_left
    # middle camera: front+middle legs and antenna of both sides
    limb_mid = np.array([True, True, False, True, False] * 2)

    vis = np.zeros((NUM_CAMERAS, num_joints), dtype=bool)
    for cam in range(NUM_CAMERAS):
        if cam < 3:
            limb_vis = limb_left
        elif cam == 3:
            limb_vis = limb_mid
        else:
            limb_vis = limb_right
        for j in range(num_joints):
            ok = limb_vis[limb_id[j]]
            if cam in (2, 4) and tracked_points[j] == Tracked.STRIPE:
                ok = False
            if cam == 3 and tracked_points[j] in (
                Tracked.BODY_COXA,
                Tracked.COXA_FEMUR,
            ):
                ok = False
            vis[cam, j] = ok
    return vis


# ------------------------------------------------------------------ z-order

_zorder_left_limb = (7, 8, 6, 9, 5, 1, 0, 2, 3, 4)
_zorder_right_limb = (1, 0, 2, 3, 4, 7, 8, 6, 9, 5)
_zorder_mid_limb = (0, 1, 2, 3, 4, 0, 1, 2, 3, 4)


def _per_joint(zorder_limb):
    return np.array([zorder_limb[limb_id[j]] for j in range(num_joints)])


# --------------------------------------------------------------- bone prior

bone_param = np.full((num_joints, 2), (0.9, 0.3), dtype=float)
for _j in range(num_joints):
    if tracked_points[_j] in (Tracked.BODY_COXA, Tracked.STRIPE, Tracked.ANTENNA):
        bone_param[_j, 1] = 10000.0            # effectively no bone prior

ignore_joint_id = tuple(
    j
    for j in range(num_joints)
    if tracked_points[j]
    in (Tracked.BODY_COXA, Tracked.COXA_FEMUR, Tracked.ANTENNA)
)

skeleton = Skeleton(
    name="fly",
    tracked_points=tracked_points,
    limb_id=limb_id,
    bones=bones,
    bones3d=bones3d,
    limb_colors=limb_colors,
    camera_sees_joint_matrix=_visibility_matrix(),
    num_cameras=NUM_CAMERAS,
    zorder_left=_per_joint(_zorder_left_limb),
    zorder_right=_per_joint(_zorder_right_limb),
    zorder_mid=_per_joint(_zorder_mid_limb),
    bone_param=bone_param,
    ignore_joint_id=ignore_joint_id,
    pictorial_joint_list=tuple(range(num_joints)),
)
