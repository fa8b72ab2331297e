"""Skeleton model as data, not predicates (a copy of ``deepfly3d_tpu/skeletons/skeleton.py``).

The reference implements per-joint visibility as Python functions evaluated
one joint at a time (reference df3d/skeleton_fly.py:194-249).  For a
vectorized pipeline everything that gates computation must be a static mask
array so it folds into vectorized ops, so a `Skeleton` precomputes:

* ``camera_sees_joint``: (num_cameras, num_joints) bool matrix
* ``bone_pairs``: (num_bones, 2) int array
* per-joint limb ids, colors, z-orders

The classic fly predicates remain available as methods for API parity with
the reference (used by the correction DB / GUI paths).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Tuple

import numpy as np


class Tracked(IntEnum):
    """Joint categories (mirrors reference df3d/skeleton_fly.py:6-14)."""

    BODY_COXA = 0
    COXA_FEMUR = 1
    FEMUR_TIBIA = 2
    TIBIA_TARSUS = 3
    TARSUS_TIP = 4
    ANTENNA = 5
    STRIPE = 6


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A skeleton model: joint taxonomy, bones, visibility, draw metadata."""

    name: str
    tracked_points: Tuple[Tracked, ...]        # per-joint category
    limb_id: Tuple[int, ...]                   # per-joint limb index
    bones: Tuple[Tuple[int, int], ...]         # drawable 2D bones
    bones3d: Tuple[Tuple[int, int], ...]       # 3D-only bones
    limb_colors: Tuple[Tuple[int, int, int], ...]  # per-limb RGB
    camera_sees_joint_matrix: np.ndarray       # (num_cameras, num_joints) bool
    num_cameras: int
    zorder_left: np.ndarray                    # per-joint z-order (cam < 3)
    zorder_right: np.ndarray                   # per-joint z-order (cam > 3)
    zorder_mid: np.ndarray                     # per-joint z-order (cam == 3)
    bone_param: np.ndarray                     # (num_joints, 2) [mean, std] bone prior
    ignore_joint_id: Tuple[int, ...]           # excluded from correction checks
    pictorial_joint_list: Tuple[int, ...]      # joints covered by pictorial MAP

    # ------------------------------------------------------------------ sizes
    @property
    def num_joints(self) -> int:
        return len(self.tracked_points)

    @property
    def num_limbs(self) -> int:
        return len(set(self.limb_id))

    # ------------------------------------------------------- reference parity
    def is_tracked_point(self, joint_id: int, tracked: Tracked) -> bool:
        return self.tracked_points[joint_id] == tracked

    def get_limb_id(self, joint_id: int) -> int:
        return self.limb_id[joint_id]

    def camera_see_joint(self, camera_id: int, joint_id: int) -> bool:
        """Visibility predicate (semantics of reference skeleton_fly.py:233-249)."""
        if camera_id == self.num_cameras:  # reference aliases cam 7 -> cam 3
            camera_id = self.num_cameras // 2
        return bool(self.camera_sees_joint_matrix[camera_id, joint_id])

    def camera_see_limb(self, camera_id: int, limb: int) -> bool:
        joints = [j for j in range(self.num_joints) if self.limb_id[j] == limb]
        return any(self.camera_see_joint(camera_id, j) for j in joints)

    def get_zorder(self, cam_id: int) -> np.ndarray:
        """Per-joint draw order for a camera view (reference skeleton_fly.py:291-301)."""
        if cam_id < self.num_cameras // 2:
            z = self.zorder_right
        elif cam_id == self.num_cameras // 2:
            z = self.zorder_mid
        else:
            z = self.zorder_left
        return np.max(z) - z

    # ------------------------------------------------------- vectorized masks
    def visibility_mask(self) -> np.ndarray:
        """(num_cameras, num_joints) float mask for vectorized gating."""
        return self.camera_sees_joint_matrix.astype(np.float64)

    def joint_colors_rgb(self) -> np.ndarray:
        """(num_joints, 3) uint8 colors, one per joint via its limb."""
        return np.array(
            [self.limb_colors[self.limb_id[j]] for j in range(self.num_joints)],
            dtype=np.uint8,
        )
