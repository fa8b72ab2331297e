"""Manual-correction store (``pose_corr*.pkl``), a copy of ``deepfly3d_tpu/io/posedb.py``.

Pickle-schema compatible with the reference PoseDB (reference df3d/db.py):
per-camera dicts of normalized (num_joints, 2) arrays plus ``train`` and
``modified`` sub-dicts; corrections are stored normalized and rescaled to
pixels on read.
"""

from __future__ import annotations

import copy
import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np


class PoseDB:
    def __init__(self, folder: str, num_cameras: int = 7, meta=None):
        self.folder = folder
        self.num_cameras = num_cameras
        self.last_write_image_id = 0

        existing = glob.glob(os.path.join(folder, "pose_corr*.pkl"))
        if existing:
            self.db_path = existing[0]
            with open(self.db_path, "rb") as f:
                self.db = pickle.load(f)
        else:
            # filename convention of reference df3d/db.py:22-24
            self.db_path = os.path.join(
                folder, "pose_corr_{}.pkl".format(folder.replace("/", "-"))
            )
            self.db = {i: dict() for i in range(num_cameras)}
            self.db["folder"] = folder
            self.db["meta"] = meta
            self.db["train"] = {i: dict() for i in range(num_cameras)}
            self.db["modified"] = {i: dict() for i in range(num_cameras)}
            self.dump()

    def read(self, cam_id: int, img_id: int) -> Optional[np.ndarray]:
        if img_id in self.db[cam_id]:
            return np.array(self.db[cam_id][img_id])
        return None

    def read_modified_joints(self, cam_id: int, img_id: int) -> List[int]:
        return self.db["modified"][cam_id].get(img_id, [])

    def write(self, pts, cam_id, img_id, train: bool, modified_joints: List[int]):
        pts = np.asarray(pts)
        assert pts.ndim == 2 and pts.shape[1] == 2
        assert modified_joints is not None
        self.db[cam_id][img_id] = pts
        self.db["train"][cam_id][img_id] = train
        self.db["modified"][cam_id][img_id] = modified_joints
        self.last_write_image_id = img_id

    def remove_corrections(self, cam_id: int, img_id: int):
        for sub in (self.db, self.db["train"], self.db["modified"]):
            table = sub if sub is self.db else sub
            if img_id in table.get(cam_id, {}):
                del table[cam_id][img_id]

    def has_key(self, cam_id: int, img_id: int) -> bool:
        return img_id in self.db[cam_id]

    def dump(self):
        with open(self.db_path, "wb") as f:
            pickle.dump(self.db, f)

    def manual_corrections(self, image_shape) -> Dict[int, Dict[int, np.ndarray]]:
        """Corrections rescaled to pixels by image_shape=(width, height)."""
        out = {c: copy.deepcopy(self.db[c]) for c in range(self.num_cameras)}
        scale = np.asarray(image_shape, dtype=np.float64)
        for cam_id in out:
            for img_id in out[cam_id]:
                out[cam_id][img_id] = np.array(out[cam_id][img_id]) * scale
        return out
