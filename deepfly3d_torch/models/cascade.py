"""Student pass + selective parity repair, on the device.

Counterpart of ``deepfly3d_tpu/models/cascade.py``.  The only checkpoint
whose argmax cells are exact against the golden recording is the 2-stack
f96 conv-stem teacher; the fast students leave a small residue of wrong
cells.  The cascade holds the teacher's points at student speed:

1. the student runs on every image;
2. each image (camera, frame) is scored by leave-one-out multi-view
   consistency (``loo_suspicion``): the frame is triangulated without that
   camera and the camera's own points are reprojected against that
   reconstruction, so the blame for a wrong cell lands on its own camera;
3. the R = ceil(repair_frac * N) most suspicious images (ties to the lower
   image index, as ``jax.lax.top_k``) run again through the teacher, and
   their points replace the student's; the confidences stay the student's.

Each net preprocesses at its own input shape, so the preprocess kernel runs
at two shapes and the bottleneck, upsample-add and decode kernels for two
nets.  The output contract is ``pipeline.build_pipeline``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.pipeline import Pipeline, device_setup
from deepfly3d_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    repair_frac: float = 0.125   # fraction of images re-run on the teacher


def loo_suspicion(p38: torch.Tensor, R: torch.Tensor, tvec: torch.Tensor,
                  intr: torch.Tensor, image_shape: Tuple[int, int]) -> torch.Tensor:
    """Per-image leave-one-out suspicion scores, (C, T, 38, 2) -> (C, T).

    For each camera c the frame is DLT-triangulated without c's
    observations and c's own points are reprojected against that
    reconstruction; the score of image (c, t) is the worst per-joint pixel
    residual.  Joints whose leave-one-out reconstruction has fewer than two
    observers are excluded.  The JAX function vmaps over the left-out
    camera; here that camera is a leading dimension folded into the frames
    of one ``triangulate`` call.  A camera with no observation (the middle
    camera's joints are all discarded by the 19->38 assembly) scores 0.
    """
    C, T, J, _ = p38.shape
    keep = 1.0 - torch.eye(C, dtype=p38.dtype, device=p38.device)   # (left out, camera)
    obs_mask = geometry.observation_mask(p38)                       # (C, T, J)
    p_loo = p38[None] * keep[:, :, None, None, None]                # (C, C, T, J, 2)
    p_frames = p_loo.transpose(0, 1).reshape(C, C * T, J, 2)         # frames (left out, t)
    pts3d = geometry.triangulate(p_frames, R, tvec, intr, image_shape,
                                 method="normal").reshape(C, T, J, 3)
    dist0 = torch.zeros((C, 5), dtype=p38.dtype, device=p38.device)
    proj = geometry.project(pts3d, R, tvec, intr, dist0)            # camera c, its own LOO points
    obs = geometry.rowcol_to_pixel_xy(p38, image_shape)
    res = (proj - obs) * obs_mask[..., None].to(proj.dtype)
    loo_valid = (obs_mask[None].to(p38.dtype) * keep[:, :, None, None]).sum(dim=1) >= 2
    err = torch.linalg.vector_norm(res, dim=-1) * obs_mask * loo_valid
    return err.amax(dim=-1)


def top_r(scores: torch.Tensor, r: int) -> torch.Tensor:
    """Indices of the ``r`` largest scores, ties to the lower index (``jax.lax.top_k``)."""
    return torch.sort(scores, descending=True, stable=True).indices[:r]


class CascadePipeline(Pipeline):
    """Callable cascade; see ``build_cascade_pipeline``.

    ``net`` is the student, ``teacher`` the parity net; ``last_repaired``
    holds the image indices (t * C + c) the last call re-ran on the teacher.
    """

    def __init__(self, student: FoldedHourglass, teacher: FoldedHourglass,
                 student_shape, teacher_shape, cfg: CascadeConfig, rig, calib,
                 camera_ordering, device, num_cameras, image_hw):
        super().__init__(student, rig, calib, camera_ordering, student_shape, device,
                         num_cameras, image_hw)
        self.teacher = teacher
        self.teacher_shape = tuple(teacher_shape)
        self.cfg = cfg
        self.last_repaired = None

    def nets(self) -> dict:
        return {"net": self.net, "teacher": self.teacher}

    @torch.inference_mode()
    def __call__(self, frames_u8: Union[np.ndarray, torch.Tensor]):
        with span("call"):
            x_u8, flip, reg, shift, T = self._register(frames_u8)
            N = x_u8.shape[0]
            pts_s, conf_s = self._points(self.net, x_u8, flip, reg, self.input_shape)
            score = loo_suspicion(self._assemble(pts_s, T), self.R, self.tvec, self.intr,
                                  self.image_hw[::-1])
            n_repair = max(int(math.ceil(self.cfg.repair_frac * N)), 1)
            idx = top_r(score.T.reshape(N), n_repair)          # image-major (t, c)
            reg_t = None if reg is None else tuple(t[idx] for t in reg)
            pts_t, _ = self._points(self.teacher, x_u8[idx], flip[idx], reg_t,
                                    self.teacher_shape)
            pts = pts_s.clone()
            pts[idx] = pts_t
            self.last_repaired = idx
            pts3d, p38 = self._finish(self._assemble(pts, T), shift)
            return pts3d, p38, self._conf(conf_s, T)


def build_cascade_pipeline(student_vars, student_spec: HourglassSpec, teacher_vars,
                           teacher_spec: HourglassSpec, calib, camera_ordering,
                           cfg: CascadeConfig = CascadeConfig(), rig="auto",
                           device="cuda") -> CascadePipeline:
    """-> callable: (T, C, H, W, 3) uint8 ->
    (points3d (T, 38, 3), points2d38 (C, T, 38, 2), conf (C, T, 19, 1)).

    Each net runs at its checkpoint's ``input_shape`` (256x512 when it has
    none).  ``rig``: ``"auto"`` for the shipped template, a path, or None;
    frames are registered before both passes.  Raises when ``device`` is
    ``"cuda"`` and there is no card.
    """
    dev, rig_arrays, calib_t, fly = device_setup(calib, rig, device)
    nets = [FoldedHourglass(fold_hourglass(v, s), s).to(dev).eval()
            for v, s in ((student_vars, student_spec), (teacher_vars, teacher_spec))]
    shapes = [tuple(s.input_shape or (256, 512)) for s in (student_spec, teacher_spec)]
    return CascadePipeline(nets[0], nets[1], shapes[0], shapes[1], cfg, rig_arrays,
                           calib_t, camera_ordering, dev, fly.num_cameras, fly.image_hw)
