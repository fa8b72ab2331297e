"""The golden 2D->3D inference path as one callable on the device.

Counterpart of ``bench.py::build_pipeline``:

    (T, C, 480, 960, 3) uint8
      -> rig registration: estimate an integer shift and a gain per camera
         (identity on clean input)
      -> the shift, /255, flip of the right-side cameras, antialiased
         bilinear resize and gain correction in one pass (preprocess kernel)
      -> folded stacked hourglass (bottleneck and upsample-add kernels)
      -> argmax decode (decode kernel)
      -> 19->38 assembly with the flip artifact
      -> masked DLT triangulation (closed-form "normal" method, float32)
    -> (points3d (T, 38, 3), points2d38 (C, T, 38, 2), conf (C, T, 19, 1))

Every shipped checkpoint runs here, at its own input shape.  Everything
runs in float32 with TF32 off.  ``models/cascade.py`` builds the student +
parity-repair configuration on the same stages.

Under a ``torch.profiler`` session each call is a ``df3d.call`` span and
each stage a span inside it (``utils.profiling.span``): ``register.copy``,
``register.estimate``, ``preprocess``, ``net``, ``decode``, ``assemble``
(twice: the points and the confidences) and ``triangulate``.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepfly3d_torch.config import fly_config
from deepfly3d_torch.models.decode import decode_argmax
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops import canonicalize, geometry
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.ops.bottleneck import bottleneck_plain
from deepfly3d_torch.ops.kernels import (decode_heatmaps_plain, stem_conv_plain,
                                         upsample2x_add_plain)
from deepfly3d_torch.utils.devices import full_f32, resolve_device
from deepfly3d_torch.utils.profiling import span


def assemble38(pts19: torch.Tensor, order: Sequence[int], left_cams: torch.Tensor,
               right_cams: torch.Tensor, K: int) -> torch.Tensor:
    """(C, T, 19, 2) -> (C, T, 38, 2), the reference's assembly incl. the
    flip artifact (unobserved right-side entries become col = 1.0).

    Counterpart of ``deepfly3d_tpu/models/cascade.py::_assemble38``.
    """
    C, T = pts19.shape[:2]
    p38 = torch.zeros((C, T, 2 * K, 2), dtype=torch.float32, device=pts19.device)
    p38[left_cams, :, :K] = pts19[left_cams]
    p38[right_cams, :, K:] = pts19[right_cams]
    p38[int(order[2]), :, 15:] = 0.0
    p38[int(order[4]), :, K + 15:] = 0.0
    p38[right_cams, ..., 1] = 1.0 - p38[right_cams, ..., 1]
    return p38


class Pipeline:
    """Callable golden pipeline; see ``build_pipeline``.

    ``net`` (the folded hourglass), ``preprocess`` and ``decode`` are plain
    attributes: the stages of the path, each on ``device``.
    """

    def __init__(self, net: FoldedHourglass, rig: Optional[canonicalize.TemplateArrays],
                 calib: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 camera_ordering: Sequence[int], input_shape: Tuple[int, int],
                 device: torch.device, num_cameras: int, image_hw: Tuple[int, int]):
        self.net = net
        self.preprocess = image_ops.preprocess_frames
        self.decode = decode_argmax
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

    def _register(self, frames_u8):
        """-> (frames (N, H, W, 3) as given, flip (N,), registration or None,
        shift (dy, dx) per camera or None, T).

        The registration is per image: (dy, dx) (N,) int32 and the gain
        correction (N,) float32.  The frames are not rolled here: the
        preprocess rolls them as it reads them, and multiplies by the gain as
        it writes.
        """
        with span("register.copy"):
            frames = torch.as_tensor(frames_u8).to(self.device)
        if frames.dtype != torch.uint8 or frames.dim() != 5:
            raise ValueError("frames must be (T, C, H, W, 3) uint8")
        T, C, H, W, _ = frames.shape
        if C != self.num_cameras or (H, W) != self.image_hw:
            raise ValueError(f"frames {tuple(frames.shape)} do not match the rig "
                             f"({self.num_cameras} cameras of {self.image_hw})")
        reg = shift = None
        with span("register.estimate"):
            if self.rig is not None:
                dy, dx, gain = canonicalize.estimate_tc(frames, self.rig)
                shift = (dy, dx)
                reg = (dy.repeat(T), dx.repeat(T), canonicalize.gain_correction(gain).repeat(T))
            flip = self.flip.repeat(T)
        return frames.reshape(T * C, H, W, 3).contiguous(), flip, reg, shift, T

    def _points(self, net: FoldedHourglass, x_u8, flip, reg, input_shape):
        """preprocess (with the registration) -> forward -> decode:
        (N, K, 2) points, (N, K, 1) conf."""
        img_shift, corr = (None, None) if reg is None else (reg[:2], reg[2])
        with span("preprocess"):
            x = self.preprocess(x_u8, flip, input_shape, net.spec.preprocess_dtype,
                                shift=img_shift, gain=corr)
        with span("net"):
            heatmaps = net(x)[-1]
        with span("decode"):
            return self.decode(heatmaps)

    def _assemble(self, pts: torch.Tensor, T: int) -> torch.Tensor:
        K = pts.shape[1]
        pts19 = pts.reshape(T, self.num_cameras, K, 2).permute(1, 0, 2, 3)
        with span("assemble"):
            return assemble38(pts19, self.order, self.left, self.right, K)

    def _finish(self, p38, shift):
        """Triangulate the canonical points; 2D points go out in the provided frame."""
        H, W = self.image_hw
        with span("triangulate"):
            pts3d = geometry.triangulate(p38, self.R, self.tvec, self.intr, (W, H),
                                         method="normal")
            if shift is not None:
                p38 = canonicalize.adjust_points38(p38, shift[0], shift[1], (H, W))
        return pts3d, p38

    def _conf(self, conf: torch.Tensor, T: int) -> torch.Tensor:
        K = conf.shape[1]
        with span("assemble"):
            return conf.reshape(T, self.num_cameras, K, 1).permute(1, 0, 2, 3).contiguous()

    def nets(self) -> dict:
        """The folded hourglasses this pipeline runs, by attribute name."""
        return {"net": self.net}

    @torch.inference_mode()
    def __call__(self, frames_u8: Union[np.ndarray, torch.Tensor]):
        with span("call"):
            x_u8, flip, reg, shift, T = self._register(frames_u8)
            pts, conf = self._points(self.net, x_u8, flip, reg, self.input_shape)
            pts3d, p38 = self._finish(self._assemble(pts, T), shift)
            return pts3d, p38, self._conf(conf, T)


def plain_twin(pipe: Pipeline) -> Pipeline:
    """A copy of ``pipe`` (or of a cascade) whose stages run each kernel's
    plain PyTorch version: bottleneck, upsample-add, conv stem, preprocess
    (with the registration's roll and gain as separate steps) and decode (a
    soft-argmax stage keeps its refinement and takes its cells from the plain
    decode).

    It shares the weights and the device, and launches no kernel: on a card
    it is the yardstick and the check for the kernels.
    """
    twin = copy.copy(pipe)
    for attr, net in pipe.nets().items():
        net = copy.copy(net)
        net.block_fn, net.merge_fn, net.stem_fn = (bottleneck_plain, upsample2x_add_plain,
                                                    stem_conv_plain)
        setattr(twin, attr, net)
    twin.preprocess = image_ops.preprocess_frames_plain
    if hasattr(pipe.decode, "argmax"):      # soft-argmax: its cells from the plain decode
        twin.decode = copy.copy(pipe.decode)
        twin.decode.argmax = decode_heatmaps_plain
    else:
        twin.decode = decode_heatmaps_plain
    return twin


def device_setup(calib, rig, device):
    """-> (device, rig arrays or None, (R, tvec, intr) tensors, config)."""
    dev = resolve_device(device)
    full_f32()
    cfg = fly_config()
    if rig == "auto":
        rig = cfg.rig_template_path
    rig_arrays = (canonicalize.prepare(canonicalize.load_template(rig), dev)
                  if rig else None)
    R, tvec, intr = (torch.as_tensor(np.asarray(a, np.float32)).to(dev)
                     for a in calib[:3])
    return dev, rig_arrays, (R, tvec, intr), cfg


def build_pipeline(spec: HourglassSpec, weights, calib, camera_ordering,
                   input_shape: Optional[Tuple[int, int]] = None, rig="auto",
                   device="cuda") -> Pipeline:
    """Build the golden pipeline on ``device`` (default ``"cuda"``).

    ``spec``/``weights``: any shipped checkpoint (``load_weights``);
    ``calib``: (R, tvec, intr, distort) arrays (``geometry.calib_to_arrays``),
    distortion unused (the fly rig has none); ``input_shape``: the network
    input, used only when the spec has none (the checkpoint's training
    resolution is the source of truth); ``rig``: ``"auto"`` for the shipped
    template, a template path, or None to skip registration.  Raises when
    ``device`` is ``"cuda"`` and there is no card, and for a spec the
    folded forward does not cover.
    """
    dev, rig_arrays, calib_t, cfg = device_setup(calib, rig, device)
    net = FoldedHourglass(fold_hourglass(weights, spec), spec).to(dev).eval()
    shape = tuple(spec.input_shape or input_shape or cfg.network.input_shape)
    return Pipeline(net, rig_arrays, calib_t, camera_ordering, shape,
                    dev, cfg.num_cameras, cfg.image_hw)
