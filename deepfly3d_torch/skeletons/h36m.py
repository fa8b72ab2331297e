"""Human3.6M-style 17-joint human skeleton (a copy of ``deepfly3d_tpu/skeletons/h36m.py``).

Demonstrates that the framework's skeleton model is pluggable (the reference
claims the same via its config-bound skeleton module, df3d/config.py:22-26).
All four cameras see all joints.
"""

from __future__ import annotations

import numpy as np

from deepfly3d_torch.skeletons.skeleton import Skeleton, Tracked

NUM_CAMERAS = 4

JOINT_NAMES = (
    "pelvis", "r_hip", "r_knee", "r_ankle", "l_hip", "l_knee", "l_ankle",
    "spine", "thorax", "neck", "head",
    "l_shoulder", "l_elbow", "l_wrist", "r_shoulder", "r_elbow", "r_wrist",
)
num_joints = len(JOINT_NAMES)

# limbs: 0 torso/head, 1 right leg, 2 left leg, 3 left arm, 4 right arm
limb_id = (0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 3, 3, 3, 4, 4, 4)

bones = (
    (0, 1), (1, 2), (2, 3),          # right leg
    (0, 4), (4, 5), (5, 6),          # left leg
    (0, 7), (7, 8), (8, 9), (9, 10),  # spine to head
    (8, 11), (11, 12), (12, 13),     # left arm
    (8, 14), (14, 15), (15, 16),     # right arm
)

limb_colors = (
    (210, 210, 210),
    (186, 30, 49),
    (15, 115, 153),
    (26, 141, 175),
    (201, 86, 79),
)

# generic tracked-point tags: treat limb tips as TARSUS_TIP analogues so the
# generic bone prior logic still applies
tracked_points = tuple(
    Tracked.TARSUS_TIP if j in (3, 6, 10, 13, 16) else Tracked.FEMUR_TIBIA
    for j in range(num_joints)
)

bone_param = np.full((num_joints, 2), (0.9, 0.3), dtype=float)

skeleton = Skeleton(
    name="h36m",
    tracked_points=tracked_points,
    limb_id=limb_id,
    bones=bones,
    bones3d=(),
    limb_colors=limb_colors,
    camera_sees_joint_matrix=np.ones((NUM_CAMERAS, num_joints), dtype=bool),
    num_cameras=NUM_CAMERAS,
    zorder_left=np.zeros(num_joints, dtype=int),
    zorder_right=np.zeros(num_joints, dtype=int),
    zorder_mid=np.zeros(num_joints, dtype=int),
    bone_param=bone_param,
    ignore_joint_id=(),
    pictorial_joint_list=tuple(range(num_joints)),
)
