"""Batched 2D pose inference over in-memory frames (subset of the JAX module).

Counterpart of ``deepfly3d_tpu/models/inference.py::infer_batch`` and
``PoseEstimator.infer_images``: uint8 images -> resize/normalize/flip ->
folded hourglass -> argmax decode, one batch at a time.  The JAX package
prefetches the next batch with an asynchronous ``jax.device_put``; here the
next batch is copied from pinned host memory on a side CUDA stream while
the current one computes.  Folder and video ingest (``infer_folder``,
``infer_videos``), and with them the per-recording rig registration of the
ingest path, are not ported yet.

Output contract: points (N, 19, 2) normalized (row, col) — flipped images
stay in the flipped frame — and confidences (N, 19, 1), float32 numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deepfly3d_torch.config import fly_config
from deepfly3d_torch.models import decode as decode_mod
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.utils.devices import full_f32, resolve_device


@torch.inference_mode()
def infer_batch(net: FoldedHourglass, images_u8: torch.Tensor, flip: torch.Tensor,
                input_shape: Tuple[int, int], gain: Optional[torch.Tensor] = None):
    """(N, H, W, 3) uint8 on the net's device -> (pts (N, K, 2), conf (N, K, 1)).

    ``gain``, an optional (N,) float32 exposure correction, is applied by the
    preprocess as it writes the network input.
    """
    x = image_ops.preprocess_frames(images_u8, flip, tuple(input_shape),
                                    net.spec.preprocess_dtype, gain=gain)
    return decode_mod.decode_argmax(net(x)[-1])


class PoseEstimator:
    """Loads a checkpoint once and runs batched inference on ``device``.

    Takes every shipped checkpoint (conv, patchify, patch8 and patch16 stems;
    1x1 and 3x3 score heads; subpixel heads).  The input shape is the
    checkpoint's own ``input_shape`` when it has one, else ``input_shape``,
    else the config's.
    """

    def __init__(self, checkpoint: str, input_shape: Optional[Tuple[int, int]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        full_f32()
        variables, self.spec = load_weights(checkpoint)
        self.net = FoldedHourglass(fold_hourglass(variables, self.spec),
                                   self.spec).to(self.device).eval()
        # the checkpoint's training resolution is the source of truth
        self.input_shape = tuple(self.spec.input_shape or input_shape
                                 or fly_config().network.input_shape)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _stage(self, arrays: List[Optional[np.ndarray]]):
        """Start the host-to-device copy of one batch; -> (tensors, keepalive, event).

        On a card the arrays go through pinned host memory on the side
        stream, so the copy overlaps the compute queued on the current one.
        """
        if self._copy_stream is None:
            return [None if a is None else torch.from_numpy(a) for a in arrays], None, None
        host = [None if a is None else torch.from_numpy(a).pin_memory() for a in arrays]
        with torch.cuda.stream(self._copy_stream):
            dev = [None if h is None else h.to(self.device, non_blocking=True)
                   for h in host]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, host, done

    def _wait(self, staged):
        tensors, _, done = staged
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in tensors:
                if t is not None:
                    t.record_stream(current)
        return tensors

    def infer_images(self, images_u8: np.ndarray, flip: np.ndarray,
                     batch_size: int = 8, gain: Optional[np.ndarray] = None):
        """(N, H, W, 3) uint8 + (N,) flip flags -> (pts (N, 19, 2), conf (N, 19, 1)).

        The last batch is padded with the first images (and the padding
        dropped), so every batch has ``batch_size`` images.  ``gain`` is an
        optional (N,) exposure correction (rig registration).
        """
        N = images_u8.shape[0]
        pad = (-N) % batch_size
        images_u8 = np.ascontiguousarray(images_u8, np.uint8)
        flip = np.asarray(flip, bool)
        if pad:
            images_u8 = np.concatenate([images_u8, images_u8[:pad]], axis=0)
            flip = np.concatenate([flip, flip[:pad]], axis=0)
            if gain is not None:
                gain = np.concatenate([gain, gain[:pad]], axis=0)
        if gain is not None and np.all(gain == 1.0):
            gain = None                      # identity: no gain tensor to copy
        gain = None if gain is None else np.asarray(gain, np.float32)

        def batch(i):
            sl = slice(i, i + batch_size)
            return self._stage([np.ascontiguousarray(images_u8[sl]),
                                np.ascontiguousarray(flip[sl]),
                                None if gain is None else np.ascontiguousarray(gain[sl])])

        pts_all, conf_all = [], []
        starts = list(range(0, images_u8.shape[0], batch_size))
        staged = batch(starts[0])
        for n in range(len(starts)):
            imgs, fl, g = self._wait(staged)
            if n + 1 < len(starts):
                staged = batch(starts[n + 1])      # next copy in flight
            pts, conf = infer_batch(self.net, imgs, fl, self.input_shape, g)
            pts_all.append(pts.cpu().numpy())
            conf_all.append(conf.cpu().numpy())
        return np.concatenate(pts_all)[:N], np.concatenate(conf_all)[:N]
