"""The golden 2D->3D inference path as one callable on the device.

Counterpart of ``bench.py::build_pipeline`` (folded forward):

    (T, C, 480, 960, 3) uint8
      -> rig registration (integer shift + gain, identity on clean input)
      -> /255 + antialiased bilinear resize as two matmuls, low-res flip
      -> folded stacked hourglass (bottleneck and upsample-add kernels)
      -> argmax decode (decode kernel)
      -> 19->38 assembly with the flip artifact
      -> masked DLT triangulation (closed-form "normal" method, float32)
    -> (points3d (T, 38, 3), points2d38 (C, T, 38, 2), conf (C, T, 19, 1))

Everything runs in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepfly3d_torch.config import fly_config
from deepfly3d_torch.models import cascade
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops import canonicalize, geometry
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.utils.devices import full_f32, resolve_device


class Pipeline:
    """Callable golden pipeline; see ``build_pipeline``.

    ``net`` (the folded hourglass) and ``decode`` are plain attributes: the
    stages of the path, each on ``device``.
    """

    def __init__(self, net: FoldedHourglass, rig: Optional[canonicalize.TemplateArrays],
                 calib: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 camera_ordering: Sequence[int], input_shape: Tuple[int, int],
                 device: torch.device, num_cameras: int, image_hw: Tuple[int, int]):
        self.net = net
        self.decode = cascade._decode
        self.rig = rig
        self.R, self.tvec, self.intr = calib
        self.order = np.asarray(camera_ordering)
        self.input_shape = tuple(input_shape)
        self.device = device
        self.num_cameras = num_cameras
        self.image_hw = tuple(image_hw)
        flip = np.zeros(num_cameras, bool)
        flip[self.order[4:]] = True          # right-side cameras are fed flipped
        self.flip = torch.from_numpy(flip).to(device)
        self.left = torch.from_numpy(self.order[:3].copy()).to(device)
        self.right = torch.from_numpy(self.order[4:].copy()).to(device)

    @torch.inference_mode()
    def __call__(self, frames_u8: Union[np.ndarray, torch.Tensor]):
        frames = torch.as_tensor(frames_u8).to(self.device)
        if frames.dtype != torch.uint8 or frames.dim() != 5:
            raise ValueError("frames must be (T, C, H, W, 3) uint8")
        T, C, H, W, _ = frames.shape
        if C != self.num_cameras or (H, W) != self.image_hw:
            raise ValueError(f"frames {tuple(frames.shape)} do not match the rig "
                             f"({self.num_cameras} cameras of {self.image_hw})")
        if self.rig is not None:
            dy, dx, gain = canonicalize.estimate_tc(frames, self.rig)
            frames = canonicalize.apply_shift_tc(frames, dy, dx)
        x = frames.reshape(T * C, H, W, 3)
        x = image_ops.preprocess_frames(x, self.flip.repeat(T), self.input_shape)
        if self.rig is not None:
            corr = canonicalize.gain_correction(gain).repeat(T)
            x = x * corr[:, None, None, None]
        heatmaps = self.net(x)[-1]
        pts, conf = self.decode(heatmaps)
        K = pts.shape[1]
        pts19 = pts.reshape(T, C, K, 2).permute(1, 0, 2, 3)
        conf = conf.reshape(T, C, K, 1).permute(1, 0, 2, 3).contiguous()
        p38 = cascade._assemble38(pts19, self.order, self.left, self.right, K)
        pts3d = geometry.triangulate(p38, self.R, self.tvec, self.intr, (W, H),
                                     method="normal")
        if self.rig is not None:
            p38 = canonicalize.adjust_points38(p38, dy, dx, (H, W))
        return pts3d, p38, conf


def build_pipeline(spec: HourglassSpec, weights, calib, camera_ordering,
                   input_shape: Tuple[int, int], rig="auto", device="cuda") -> Pipeline:
    """Build the golden pipeline on ``device`` (default ``"cuda"``).

    ``weights``: the checkpoint's numpy variables (``load_weights``);
    ``calib``: (R, tvec, intr, distort) arrays (``geometry.calib_to_arrays``),
    distortion unused (the fly rig has none); ``rig``: ``"auto"`` for the
    shipped template, a template path, or None to skip registration.
    Raises when ``device`` is ``"cuda"`` and there is no card.
    """
    dev = resolve_device(device)
    full_f32()
    cfg = fly_config()
    net = FoldedHourglass(fold_hourglass(weights, spec), spec).to(dev).eval()
    if rig == "auto":
        rig = cfg.rig_template_path
    rig_arrays = (canonicalize.prepare(canonicalize.load_template(rig), dev)
                  if rig else None)
    R, tvec, intr = (torch.as_tensor(np.asarray(a, np.float32)).to(dev)
                     for a in calib[:3])
    return Pipeline(net, rig_arrays, (R, tvec, intr), camera_ordering, input_shape,
                    dev, cfg.num_cameras, cfg.image_hw)
