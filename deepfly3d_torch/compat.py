"""A facade with the external pyba ``CameraNetwork`` API.

Counterpart of ``deepfly3d_tpu/compat.py``: code written against pyba's
``Camera`` / ``CameraNetwork`` (the reference drives its multi-view geometry
through them, df3d/core.py:120-126, 246-250, 355-360) runs on the port's
``bundle_adjust``, float64 SVD triangulation and reprojection error, on the
host.  ``df3d_bones`` / ``df3d_colors`` are the skeleton's, as pyba.config
exported them.  ``Camera.plot_2d`` draws through ``viz/plot2d.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deepfly3d_torch.io import discovery, result_schema
from deepfly3d_torch.ops import bundle_adjust as ba_mod
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.skeletons import fly
from deepfly3d_torch.viz import plot2d

df3d_bones = np.array(fly.bones)
df3d_colors = fly.skeleton.joint_colors_rgb()


class Camera:
    """One view of the network: 2D points in pixel (x, y) and image access."""

    def __init__(self, cam_id: int, network: "CameraNetwork"):
        self.cam_id = cam_id
        self._net = network

    @property
    def points2d(self) -> np.ndarray:
        """(T, J, 2) pixel (x, y)."""
        return self._net._points2d_xy[self.cam_id]

    def __getitem__(self, img_id: int) -> np.ndarray:
        return self.points2d[img_id]

    def is_empty(self) -> bool:
        return not np.any(self.points2d)

    def get_image(self, img_id: int) -> np.ndarray:
        return discovery.read_image(self._net.image_path.format(cam_id=self.cam_id,
                                                                img_id=img_id))

    def plot_2d(self, img_id: int, points2d: Optional[np.ndarray] = None, bones=None,
                colors=None) -> np.ndarray:
        """The fly skeleton drawn over this view's frame (``bones`` and
        ``colors`` are pyba's arguments, accepted and unused)."""
        pts = points2d if points2d is not None else self[img_id]
        return plot2d.draw_pose2d(self.get_image(img_id), pts, fly.skeleton, cam_id=self.cam_id)


class CameraNetwork:
    """pyba-compatible calibration and triangulation session.

    ``points2d`` (C, T, J, 2) in pyba's plane convention, (row_px, col_px):
    the reference passes ``stored_normalized * image_shape[::-1]``
    (reference core.py:121, 247); it is kept as pixel (x, y) and as
    normalized (row, col) for the geometry.  ``calib`` is {cam: {R, tvec,
    intr, distort}} or a whole df3d_result dict (its integer keys are taken).
    """

    def __init__(self, points2d: np.ndarray, calib: Optional[dict] = None,
                 image_path: Optional[str] = None, bones=None, colors=None,
                 image_shape=(960, 480)):
        points2d = np.asarray(points2d, dtype=np.float64)
        self.num_cameras, self.T = points2d.shape[:2]
        self._points2d_xy = points2d[..., ::-1].copy()
        self.image_shape = tuple(image_shape)
        w, h = self.image_shape
        self._points2d_rowcol = np.stack([points2d[..., 0] / h, points2d[..., 1] / w], axis=-1)
        self.image_path = image_path
        self.points3d: Optional[np.ndarray] = None
        self.calib: Optional[Dict[int, dict]] = None
        if calib is not None:
            harvested = result_schema.extract_calib(calib)
            if harvested:
                self.calib = harvested
        self.cam_list = [Camera(c, self) for c in range(self.num_cameras)]

    def __getitem__(self, cam_id: int) -> Camera:
        return self.cam_list[cam_id]

    def has_calibration(self) -> bool:
        return self.calib is not None

    def bundle_adjust(self, update_intrinsic: bool = False, update_distort: bool = False,
                      solver: str = "parity") -> float:
        assert self.calib is not None, "construct with a calibration prior first"
        result = ba_mod.bundle_adjust(self._points2d_rowcol, self.calib, self.image_shape,
                                      update_intrinsic=update_intrinsic,
                                      update_distort=update_distort, solver=solver)
        self.calib = result.calib
        return result.cost_final

    def _calib_tensors(self):
        return [torch.from_numpy(a)
                for a in geometry.calib_to_arrays(self.calib, self.num_cameras)]

    def triangulate(self) -> np.ndarray:
        R, tvec, intr, dist = self._calib_tensors()
        self.points3d = geometry.triangulate(
            torch.from_numpy(self._points2d_rowcol), R, tvec, intr, self.image_shape,
            method="svd", distort=dist).numpy()
        return self.points3d

    def reprojection_error(self) -> float:
        if self.points3d is None:
            self.triangulate()
        R, tvec, intr, dist = self._calib_tensors()
        return float(geometry.reprojection_error(
            torch.from_numpy(self.points3d), torch.from_numpy(self._points2d_rowcol),
            R, tvec, intr, dist, self.image_shape))

    def summarize(self) -> Dict[int, dict]:
        """{cam: {R, tvec, distort, intr}}, as merged into result pickles
        (reference core.py:360)."""
        return {c: {k: np.asarray(self.calib[c][k]) for k in ("R", "tvec", "distort", "intr")}
                for c in self.calib}


def procrustes_seperate(pts3d: np.ndarray) -> np.ndarray:
    """The reference's spelling (df3d/procrustes.py:51): per-side Procrustes
    onto the shipped template of the fly config."""
    from deepfly3d_torch.config import fly_config
    from deepfly3d_torch.ops import procrustes

    template = procrustes.load_template_points3d(fly_config().procrustes_template_path)
    return procrustes.procrustes_separate(pts3d, template)
