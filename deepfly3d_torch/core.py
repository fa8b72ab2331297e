"""Core session: the stateful façade over a recording folder.

Counterpart of ``deepfly3d_tpu/core.py::Core``: folder setup (video
expansion or streaming, image-shape probe, camera ordering, resume from the
result pickle), 2D inference and the 19->38 assembly, parity bundle
adjustment, float64 triangulation, Procrustes, and the bit-compatible
``df3d_result_*.pkl``.  A pickle written by either package resumes in the
other.

Device split, as in the JAX package: the network (``PoseEstimator``) runs on
``device`` (default ``"cuda"``, raising without a card), while triangulation,
bundle adjustment, Procrustes and the One-Euro filter run in float64 on the
host CPU whatever ``device`` is.

Also the pictorial-structures correction (``solve_pictorial``: the network
on ``device`` for the heatmaps, the MAP in float32 on the host), manual
corrections through the pose database, error navigation by reprojection
error, frame access, the memoised 2D smoother and ``plot_2d`` (the 2D
overlay of one view, ``viz/plot2d.py``, which the result videos and the GUI
controller draw).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from deepfly3d_torch import logger
from deepfly3d_torch.config import Config, fly_config
from deepfly3d_torch.io import discovery, result_schema
from deepfly3d_torch.io.posedb import PoseDB
from deepfly3d_torch.ops import bundle_adjust as ba_mod
from deepfly3d_torch.ops import filters, geometry, pictorial, procrustes

# Known lab-account camera orderings inferred from the folder path (the
# reference hardcodes the same table, df3d/core.py:34-42).
_KNOWN_ORDERINGS = [
    (r"/CLC/", [0, 6, 5, 4, 3, 2, 1]),
    (r"/FA/", [6, 5, 4, 3, 2, 1, 0]),
    (r"/SG/", [6, 5, 4, 3, 2, 1, 0]),
    (r"Laura", [0, 6, 5, 4, 3, 2, 1]),
    (r"AYMANNS_Florian", [6, 5, 4, 3, 2, 1, 0]),
    (r"sample/test", [0, 1, 2, 3, 4, 5, 6]),
    (r"/JB/", [6, 5, 4, 3, 2, 1, 0]),
]


def find_default_camera_ordering(input_folder: str) -> np.ndarray:
    """Infer the camera ordering from the folder path."""
    path = str(input_folder)
    for regex, order in _KNOWN_ORDERINGS:
        if re.search(regex, path):
            logger.debug(f"Default camera ordering found: {order}")
            return np.array(order)
    raise NotImplementedError(
        f"Cannot find camera ordering for folder {path}. Please set your "
        "camera ordering using the --order flag. Example usage is "
        "df3d-cli /your/path/images/ --order 0 1 2 3 4 5 6"
    )


def _f64(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


class Core:
    def __init__(
        self,
        input_folder: str,
        output_folder: Optional[str] = None,
        num_images_max: Optional[int] = None,
        camera_ordering: Optional[Sequence[int]] = (0, 1, 2, 3, 4, 5, 6),
        config: Optional[Config] = None,
        streaming: Optional[bool] = None,
        device="cuda",
    ):
        """``streaming=True`` infers straight from ``camera_{c}.mp4`` (bounded
        memory, no JPEGs written); ``None`` streams recordings longer than
        ``config.streaming_auto_threshold`` frames that are not expanded yet;
        ``False`` always expands to JPEGs.  ``device`` is the network's."""
        self.config = config or fly_config()
        self.device = device
        self.input_folder = input_folder
        self.output_folder = (
            output_folder if output_folder is not None else self._input_folder + "_df3d"
        )

        if streaming is None:
            streaming = self._auto_streaming(num_images_max)
        self.streaming = bool(streaming)

        if self.streaming and not discovery.list_videos(self._input_folder):
            logger.warning(
                "streaming requested but no camera videos found; "
                "falling back to the image pipeline"
            )
            self.streaming = False
        if not self.streaming:
            self.expand_videos()
        self.fps = self.get_fps()
        self.num_images_max = num_images_max if num_images_max is not None else 0
        if self.streaming:
            self.max_img_id = discovery.video_frame_count(self._input_folder) - 1
        else:
            self.max_img_id = discovery.get_max_img_id(
                self._input_folder, self.config.num_cameras
            )
        if self.num_images_max > 0:
            self.num_images = min(self.num_images_max, self.max_img_id + 1)
            self.max_img_id = self.num_images - 1
        else:
            self.num_images = self.max_img_id + 1

        self._probe_image_shape()
        self.db = PoseDB(self._output_folder, self.config.num_cameras)
        self.camera_ordering = self.setup_camera_ordering(camera_ordering)

        self.points2d: Optional[np.ndarray] = None   # (C,T,J,2) normalized (row,col)
        self.conf: Optional[np.ndarray] = None       # (C,T,J/2,1)
        self.points3d: Optional[np.ndarray] = None   # (T,J,3) post-procrustes
        self.calib: Optional[dict] = None            # {cam: {R,tvec,intr,distort}}
        self._points3d_wo: Optional[np.ndarray] = None
        self._smooth_cache: dict = {}
        self._estimator = None

        # resume from an existing result pickle
        if os.path.exists(self.save_path):
            saved = result_schema.load_result(self.save_path)
            self.points2d = saved["points2d"]
            self.conf = saved.get("heatmap_confidence")
            if "points3d" in saved:
                self.points3d = saved["points3d"]
            if "points3d_wo_procrustes" in saved:
                self._points3d_wo = saved["points3d_wo_procrustes"]
            calib = result_schema.extract_calib(saved)
            if calib:
                self.calib = calib

    # ------------------------------------------------------------ properties

    @property
    def input_folder(self) -> str:
        return self._input_folder

    @input_folder.setter
    def input_folder(self, value: str):
        value = os.path.abspath(str(value)).rstrip("/")
        if not os.path.isdir(value):
            raise NotADirectoryError(f"Not a directory {value}")
        self._input_folder = value

    @property
    def output_folder(self) -> str:
        return self._output_folder

    @output_folder.setter
    def output_folder(self, value: str):
        os.makedirs(value, exist_ok=True)
        self._output_folder = os.path.abspath(str(value)).rstrip("/")

    @property
    def number_of_joints(self) -> int:
        return self.config.num_joints

    @property
    def has_pose(self) -> bool:
        return self.points2d is not None

    @property
    def has_calibration(self) -> bool:
        return self.calib is not None

    @property
    def save_path(self) -> str:
        return result_schema.result_path(self._output_folder, self._input_folder)

    @property
    def image_shape(self) -> List[int]:
        """[width, height]."""
        return list(self._image_shape)

    # --------------------------------------------------------------- setup

    def _auto_streaming(self, num_images_max) -> bool:
        """Stream iff camera videos exist, the folder is not expanded to JPEGs
        yet, and the frame count (capped by ``num_images_max``) exceeds
        ``config.streaming_auto_threshold``."""
        if not discovery.list_videos(self._input_folder):
            return False
        already_expanded = any(
            os.path.exists(os.path.join(self._input_folder, f"camera_{c}_img_0.jpg"))
            for c in range(self.config.num_cameras)
        )
        if already_expanded:
            return False
        n = discovery.video_frame_count(self._input_folder)
        if num_images_max:
            n = min(n, int(num_images_max))
        if n > self.config.streaming_auto_threshold:
            logger.info(
                f"recording has {n} frames (> {self.config.streaming_auto_threshold}): "
                "using the bounded-memory streaming pipeline (pass streaming=False "
                "/ --no-streaming to force JPEG expansion)"
            )
            return True
        return False

    def _probe_image_shape(self):
        template = discovery.image_path_template(self._input_folder)
        image0 = template.format(cam_id=0, img_id=0)
        probed = None
        if os.path.exists(image0):
            img = discovery.read_image(image0)
            probed = [img.shape[1], img.shape[0]]   # [width, height]
        elif self.streaming:
            vids = discovery.list_videos(self._input_folder)
            if vids:
                img = discovery.read_video_frame(vids[0], 0)
                probed = [img.shape[1], img.shape[0]]
        configured = self.config.image_shape
        if configured is not None and probed is not None and list(configured) != probed:
            raise ValueError(
                f"Actual image shape {probed} does not match configured "
                f"image shape {list(configured)}"
            )
        shape = probed or (list(configured) if configured else None)
        if shape is None:
            raise ValueError(
                f"Image shape not configured and could not be read from {image0}"
            )
        self._image_shape = tuple(shape)
        self.config.image_shape = tuple(shape)

    def setup_camera_ordering(self, camera_ordering) -> np.ndarray:
        if camera_ordering is None:
            return find_default_camera_ordering(self._input_folder)
        return np.array(list(camera_ordering))

    def update_camera_ordering(self, ordering) -> bool:
        """Replace the camera ordering; False (and no change) on invalid input."""
        if ordering is None:
            return False
        ordering = np.asarray(list(ordering))
        if sorted(ordering.tolist()) != list(range(self.config.num_cameras)):
            return False
        self.camera_ordering = ordering
        self._invalidate_downstream()
        return True

    def check_cameras(self):
        """Assert every camera but the middle one (whose predictions the
        assembly discards) contributed 2D observations."""
        assert self.points2d is not None, "Run pose estimation first."
        middle = self.camera_ordering[3]
        missing = [
            cam
            for cam in range(self.config.num_cameras)
            if cam != middle and not np.any(self.points2d[cam])
        ]
        assert not missing, f"Some cameras are missing: {missing}"

    # ------------------------------------------------------------ pipeline

    def pose2d_estimation(
        self,
        batch_size: int = 8,
        disable_pin_memory: bool = False,   # accepted for CLI parity; no-op
        checkpoint: Optional[str] = None,
        soft_argmax: bool = False,
    ):
        """Hourglass inference over the recording on ``device``, then the
        19->38 assembly (side scatter, stripe zeroing, right-camera unflip
        with its 1.0 artifact)."""
        from deepfly3d_torch.models import decode as decode_mod
        from deepfly3d_torch.models.inference import PoseEstimator

        # the estimator is cached: ``soft_argmax`` takes effect when it is built
        # (the first call, or one that names a checkpoint), as in the JAX Core
        ckpt = checkpoint or self.config.network.checkpoint
        if self._estimator is None or checkpoint is not None:
            self._estimator = PoseEstimator(
                ckpt,
                input_shape=self.config.network.input_shape,
                device=self.device,
                soft_argmax=soft_argmax,
            )
        flip = [
            cam
            for idx, cam in enumerate(self.camera_ordering)
            if idx in self.config.flip_cameras
        ]
        if self.streaming:
            pts19, conf = self._estimator.infer_videos(
                self._input_folder,
                camera_ids_to_flip=flip,
                batch_size=batch_size,
                num_cameras=self.config.num_cameras,
                max_frames=self.num_images,
            )
        else:
            pts19, conf = self._estimator.infer_folder(
                self._input_folder,
                camera_ids_to_flip=flip,
                max_img_id=self.max_img_id,
                batch_size=batch_size,
                num_cameras=self.config.num_cameras,
            )
        if self.config.network.num_predict == self.config.num_joints:
            self.points2d = np.asarray(pts19, dtype=np.float64)
        else:
            self.points2d = decode_mod.postprocess_points2d(
                pts19, self.camera_ordering, self.config.num_joints
            )
        self.conf = conf
        self._invalidate_downstream()

    def calibrate_calc(self, min_img_id: int = 0, max_img_id: int = 10**9,
                       solver: str = "parity", **solver_kwargs):
        """Bundle-adjust the extrinsics from the calibration prior, re-keyed by
        the camera ordering (float64, host); prints the reprojection error."""
        with open(self.config.calib_prior_path, "rb") as f:
            prior = pickle.load(f)
        prior = {cidx: prior[idx] for idx, cidx in enumerate(self.camera_ordering)}
        result = ba_mod.bundle_adjust(
            self.points2d,
            prior,
            tuple(self._image_shape),
            update_intrinsic=False,
            update_distort=False,
            solver=solver,
            **solver_kwargs,
        )
        self.calib = result.calib
        self._invalidate_downstream()
        err = self.reprojection_error()
        print(f"Reprojection error is {err}")
        return result

    def solve_pictorial(self, batch_size: int = 8, apply: bool = True) -> dict:
        """Pictorial-structures MAP correction of the legs (``ops/pictorial.py``).

        Per body side, the top-k peaks of the last stack's heatmaps (the
        network on ``device``) in the side's three cameras become pixel
        candidates, and ``correct_legs_map`` picks each leg chain's MAP 3D
        points on the host in float32.  Returns {"left": (T, 15, 3), "right":
        (T, 15, 3)}; with ``apply`` the corrected legs are reprojected into
        each side's cameras and written into ``self.points2d``.
        """
        from deepfly3d_torch.models.inference import PoseEstimator

        assert self.has_calibration, "Calibrate first."
        if self._estimator is None:
            self._estimator = PoseEstimator(
                self.config.network.checkpoint,
                input_shape=self.config.network.input_shape,
                device=self.device,
            )
        order = list(self.camera_ordering)
        flip = [cam for idx, cam in enumerate(order) if idx > 3]
        _, _, heatmaps = self._estimator.infer_folder(
            self._input_folder,
            camera_ids_to_flip=flip,
            max_img_id=self.max_img_id,
            batch_size=batch_size,
            num_cameras=self.config.num_cameras,
            return_heatmap=True,
        )
        W, H = self._image_shape
        bp = self.config.bp
        params = pictorial.PictorialParams(bp.num_peak, bp.upper_bound, bp.alpha_reproj,
                                           bp.alpha_heatmap, bp.alpha_bone)
        bone_param = self.config.skeleton.bone_param
        legs, leg_len = 3, 5
        n_leg = legs * leg_len
        f32 = torch.float32

        out = {}
        for side, positions, joint0 in (("left", (0, 1, 2), 0), ("right", (4, 5, 6), 19)):
            cams = [order[p] for p in positions]
            hm = heatmaps[cams]                                  # (3, T, h, w, 19)
            C3, T = hm.shape[:2]
            coords, scores = pictorial.top_k_peaks(
                torch.from_numpy(np.ascontiguousarray(hm.reshape((C3 * T,) + hm.shape[2:]),
                                                      np.float32)), k=params.num_peak)
            coords = coords.numpy().reshape(C3, T, 19, params.num_peak, 2)
            scores = scores.numpy().reshape(C3, T, 19, params.num_peak)
            if side == "right":                                  # unflip the columns
                coords[..., 1] = 1.0 - coords[..., 1]
            cand_xy = np.stack([coords[..., 1] * W, coords[..., 0] * H], axis=-1)
            R, tvec, intr, _ = _f64(*geometry.calib_to_arrays(
                {i: self.calib[c] for i, c in enumerate(cams)}, C3))
            P = geometry.projection_matrices(R, tvec, intr)
            edge_joints = np.asarray([joint0 + l * leg_len + e + 1
                                      for l in range(legs) for e in range(leg_len - 1)])
            pts3d = pictorial.correct_legs_map(
                torch.as_tensor(cand_xy[:, :, :n_leg], dtype=f32),
                torch.as_tensor(scores[:, :, :n_leg], dtype=f32),
                P.to(f32),
                torch.as_tensor(bone_param[edge_joints, 0], dtype=f32),
                torch.as_tensor(bone_param[edge_joints, 1], dtype=f32),
                params, legs=legs, leg_len=leg_len,
            ).numpy()                                            # (T, 15, 3)
            out[side] = pts3d
            if apply:
                flat = torch.from_numpy(pts3d.reshape(1, -1, 3).astype(np.float64))
                for i, cam in enumerate(cams):
                    px = geometry.project(flat, R[i:i + 1], tvec[i:i + 1], intr[i:i + 1],
                                          torch.zeros((1, 5), dtype=torch.float64))
                    px = px.numpy().reshape(T, n_leg, 2)
                    self.points2d[cam, :, joint0:joint0 + n_leg, 0] = px[..., 1] / H
                    self.points2d[cam, :, joint0:joint0 + n_leg, 1] = px[..., 0] / W
        if apply:
            self._invalidate_downstream()
        return out

    def triangulate(self) -> np.ndarray:
        """Float64 SVD DLT of the current points2d with the current calibration."""
        assert self.has_calibration, "Calibrate first."
        R, tvec, intr, dist = _f64(*geometry.calib_to_arrays(self.calib,
                                                              self.config.num_cameras))
        self._points3d_wo = geometry.triangulate(
            *_f64(self.points2d), R, tvec, intr, tuple(self._image_shape),
            method="svd", distort=dist,
        ).numpy()
        return self._points3d_wo

    def reprojection_error(self) -> float:
        if self._points3d_wo is None:
            self.triangulate()
        R, tvec, intr, dist = _f64(*geometry.calib_to_arrays(self.calib,
                                                              self.config.num_cameras))
        return float(geometry.reprojection_error(
            *_f64(self._points3d_wo, self.points2d), R, tvec, intr, dist,
            tuple(self._image_shape)))

    def save(self):
        """Write the ``df3d_result`` pickle (triangulated and Procrustes-aligned
        3D points when calibrated)."""
        points3d = None
        points3d_wo = None
        if self.has_calibration:
            points3d_wo = self.triangulate()
            if self.config.procrustes_apply:
                points3d = procrustes.procrustes_separate(
                    points3d_wo, self._template_points3d()
                )
            else:
                points3d = np.array(points3d_wo)
            self.points3d = points3d
        else:
            logger.debug("Triangulation skipped.")
        result_schema.save_result(
            self.save_path,
            points2d=self.points2d,
            camera_ordering=self.camera_ordering,
            heatmap_confidence=self.conf,
            calib=self.calib,
            points3d=points3d,
            points3d_wo_procrustes=points3d_wo,
        )
        print(f"Saved results at: {self.save_path}")

    def get_points3d(self) -> np.ndarray:
        """Procrustes, median-centring and axis rotation, then the One-Euro filter."""
        if self._points3d_wo is None:
            self.triangulate()
        if self.config.procrustes_apply:
            pts = procrustes.procrustes_separate(
                np.copy(self._points3d_wo), self._template_points3d()
            )
        else:
            pts = np.copy(self._points3d_wo)
        pts = procrustes.normalize_pose_3d(pts, rotate=True)
        return filters.filter_batch(pts)

    def _template_points3d(self) -> np.ndarray:
        return procrustes.load_template_points3d(self.config.procrustes_template_path)

    def _invalidate_downstream(self):
        self._points3d_wo = None
        self._smooth_cache = {}

    # ------------------------------------------------------------- media

    def expand_videos(self):
        discovery.expand_videos(self._input_folder)

    def get_fps(self) -> Optional[float]:
        return discovery.probe_fps(self._input_folder)

    def delete_images(self):
        discovery.delete_images(self._input_folder)

    # -------------------------------------------------- corrections / GUI

    def points2d_pixels_xy(self, cam_id: int, img_id: int) -> np.ndarray:
        """(J, 2) pixel (x, y) predictions for one view."""
        p = self.points2d[cam_id, img_id]
        w, h = self._image_shape
        return np.stack([p[:, 1] * w, p[:, 0] * h], axis=-1)

    def corrected_points2d(self, cam_id: int, img_id: int) -> np.ndarray:
        """The view's manually corrected (x, y) pixels where the pose database
        holds a correction, else its predictions."""
        pts = self.points2d_pixels_xy(cam_id, img_id).copy()
        corrections = self.db.manual_corrections(self._image_shape)
        if img_id in corrections.get(cam_id, {}):
            pts[:] = corrections[cam_id][img_id]
        return pts

    def corrected_points2d_matrix(self) -> np.ndarray:
        """(C, T, J, 2) pixel (x, y) with the manual corrections applied."""
        w, h = self._image_shape
        pts = np.stack([self.points2d[..., 1] * w, self.points2d[..., 0] * h], axis=-1)
        corrections = self.db.manual_corrections(self._image_shape)
        for cam_id in range(self.config.num_cameras):
            for img_id in corrections.get(cam_id, {}):
                if img_id < pts.shape[1]:
                    pts[cam_id, img_id] = corrections[cam_id][img_id]
        return pts

    def nearest_joint(self, cam_id: int, img_id: int, x: float, y: float) -> int:
        """Index of the joint nearest to pixel (x, y) among those the camera sees."""
        pts = self.corrected_points2d(cam_id, img_id)
        visible = self.config.skeleton.camera_sees_joint_matrix[cam_id]
        d2 = np.sum((pts - np.array([x, y])) ** 2, axis=-1)
        return int(np.argmin(np.where(visible, d2, np.inf)))

    def move_joint(self, cam_id: int, img_id: int, joint_id: int, x: float, y: float):
        modified = sorted(set(self.db.read_modified_joints(cam_id, img_id) + [joint_id]))
        pts = self.corrected_points2d(cam_id, img_id)
        pts[joint_id] = np.array([x, y])
        self.write_corrections(cam_id, img_id, modified, pts)

    def write_corrections(self, cam_id: int, img_id: int, modified_joints: List[int],
                          points2d_xy):
        """Persist a correction that moves a checked joint more than 30 px (L1
        per axis) from the prediction; otherwise drop the view's correction
        (reference core.py:509-544)."""
        l1_threshold = 30
        skel = self.config.skeleton
        l1 = np.abs(self.points2d_pixels_xy(cam_id, img_id) - points2d_xy)
        check = [j for j in range(skel.num_joints)
                 if j not in skel.ignore_joint_id and skel.camera_see_joint(cam_id, j)]
        unseen = [j for j in range(skel.num_joints) if not skel.camera_see_joint(cam_id, j)]
        if np.any(l1[check] > l1_threshold):
            pts = np.array(points2d_xy, dtype=np.float64)
            pts[unseen] = 0.0
            pts = pts / np.asarray(self._image_shape, dtype=np.float64)
            self.db.write(pts, cam_id, img_id, True, modified_joints)
        else:
            self.db.remove_corrections(cam_id, img_id)

    def save_corrections(self):
        self.db.dump()

    # ------------------------------------------------------ error navigation

    def next_error(self, img_id: int) -> Optional[int]:
        """The next frame after ``img_id`` with a joint reprojected more than
        ``config.reproj_thr_px`` from its observation, or None."""
        return self._next_error_in_range(range(img_id + 1, self.max_img_id + 1))

    def prev_error(self, img_id: int) -> Optional[int]:
        return self._next_error_in_range(range(img_id - 1, -1, -1))

    def _joint_reprojection_errors(self) -> np.ndarray:
        """(T, J) largest pixel reprojection error over the cameras (float64, host)."""
        if self._points3d_wo is None:
            self.triangulate()
        R, tvec, intr, dist = _f64(*geometry.calib_to_arrays(self.calib,
                                                              self.config.num_cameras))
        res, _ = geometry.reprojection_residuals(
            *_f64(self._points3d_wo, self.points2d), R, tvec, intr, dist,
            tuple(self._image_shape))
        return torch.linalg.vector_norm(res, dim=-1).numpy().max(axis=0)

    def _next_error_in_range(self, rng) -> Optional[int]:
        if not self.has_calibration:
            return None
        errors = self._joint_reprojection_errors()
        thr = self.config.reproj_thr_px
        pictorial_joints = set(self.config.skeleton.pictorial_joint_list)
        joints = [j for j in range(self.config.num_joints) if j in pictorial_joints]
        for img_id in rng:
            if 0 <= img_id < errors.shape[0] and np.any(errors[img_id, joints] > thr):
                return int(img_id)
        return None

    def joint_has_error(self, img_id: int, joint_id: int) -> bool:
        errors = self._joint_reprojection_errors()
        return bool(errors[img_id, joint_id] > self.config.reproj_thr_px)

    # ------------------------------------------------------------- frames

    def get_image(self, cam_id: int, img_id: int) -> np.ndarray:
        """One RGB frame: the JPEG, or the camera video's frame when streaming."""
        path = discovery.image_path_template(self._input_folder).format(
            cam_id=cam_id, img_id=img_id)
        if self.streaming and not os.path.exists(path):
            vid = os.path.join(self._input_folder, f"camera_{cam_id}.mp4")
            return discovery.read_video_frame(vid, img_id)
        return discovery.read_image(path)

    def smooth_points2d(self, cam_id: int) -> np.ndarray:
        """The camera's (T, J, 2) pixel (x, y) tracks through ``smooth_pose2d``,
        memoised until the points change."""
        if cam_id not in self._smooth_cache:
            w, h = self._image_shape
            pts = np.stack([self.points2d[cam_id, ..., 1] * w,
                            self.points2d[cam_id, ..., 0] * h], axis=-1)
            self._smooth_cache[cam_id] = filters.smooth_pose2d(pts)
        return self._smooth_cache[cam_id]

    def plot_2d(self, cam_id: int, img_id: int, with_corrections: bool = False,
                smooth: bool = False, joints: Sequence[int] = ()) -> np.ndarray:
        """The 2D pose overlay of one view (reference core.py:298-319): the
        corrected, smoothed or raw points drawn over ``get_image``."""
        from deepfly3d_torch.viz import plot2d

        if with_corrections:
            pts = self.corrected_points2d(cam_id, img_id)
        elif smooth:
            pts = self.smooth_points2d(cam_id)[img_id]
        else:
            pts = self.points2d_pixels_xy(cam_id, img_id)
        return plot2d.draw_pose2d(
            self.get_image(cam_id, img_id), pts, self.config.skeleton, cam_id=cam_id,
            joints=joints, line_thickness=self.config.line_thickness,
            scatter_r=self.config.scatter_r)
