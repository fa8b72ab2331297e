"""The CLI's 2D ingest written out plainly: what the ``estimator`` entry is held to.

A recording's chunks of T frames of C cameras, (T, C, H, W, 3) uint8, go through

1. the rig registration, once for the recording: per camera, from the
   recording's first chunk, the shift and gain of ``pipeline.register``
   (the rig template's profiles correlated over integer offsets in [-8, 8],
   the first best taken; the gain the ratio of mean intensities, 1 inside a
   +-1.5% dead zone); a camera with fewer than ``MIN_FRAMES`` frames in that
   chunk gets the identity;
2. per image, the frame rolled back by the shift, /255, flipped left-right
   on the flipped cameras, PyTorch's antialiased bilinear resize to the
   network's input, times the measured gain: the ingest multiplies by it
   where the 2D->3D call divides (DeepFly3D's ingest convention, kept);
3. the stacked hourglass (``hourglass.py``), the last stack's heatmaps;
4. per heatmap and joint the first maximal cell, (row / h, col / w) in
   float32, and the maximum as the confidence;
5. the points moved to the provided frame: plus (dy / H, dx / W) in float64,
   the column's term negated on a flipped camera, whose points stay in the
   flipped frame.

Departures from the program's documented behaviour, none of which changes
an answer unless a correlation ties: the profiles are float64 means of
integer sums, where the host estimator forms them as float32 means; the
images go through in blocks of ``block`` per camera, where the CLI runs
batches of 8 camera-major.  Every product is float32 with TF32 off unless
``tf32`` is asked for (the control).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import pipeline as ref

MIN_FRAMES = 8


class Registration(NamedTuple):
    dy: np.ndarray                 # (C,) int64
    dx: np.ndarray
    gain: np.ndarray               # (C,) float64


def register(first_chunk: torch.Tensor, rig: ref.Rig) -> Registration:
    """The recording's registration, from its first chunk (T, C, H, W, 3)."""
    T, C = first_chunk.shape[:2]
    if T < MIN_FRAMES:
        return Registration(np.zeros(C, np.int64), np.zeros(C, np.int64), np.ones(C))
    dy, dx, gain = ref.register(first_chunk, rig)
    return Registration(dy.astype(np.int64), dx.astype(np.int64), gain)


def flipped(rig: ref.Rig) -> np.ndarray:
    """(C,) bool: the cameras at ordering positions 4-6, which the network sees flipped."""
    flip = np.zeros(len(rig.order), bool)
    flip[rig.order[4:]] = True
    return flip


class Result(NamedTuple):
    points2d: np.ndarray           # (C, T, K, 2) float64, provided frame
    conf: np.ndarray               # (C, T, K, 1) float32
    heatmaps: torch.Tensor         # (C*T, K, h, w) float32 camera-major, on the device


def run(frames: torch.Tensor, net, rig: ref.Rig, reg: Registration, image_hw,
        block: int = 32, tf32: bool = False) -> Result:
    """One chunk (T, C, H, W, 3) uint8 under the recording's registration."""
    T, C = frames.shape[:2]
    H, W = image_hw
    flip = flipped(rig)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            maps = []
            for c in range(C):
                x = torch.roll(frames[:, c], shifts=(-int(reg.dy[c]), -int(reg.dx[c])),
                               dims=(1, 2))
                x = x.permute(0, 3, 1, 2).float() / 255.0
                if flip[c]:
                    x = x.flip(3)
                x = F.interpolate(x, size=tuple(rig.input_shape), mode="bilinear",
                                  align_corners=False, antialias=True)
                x = x * np.float32(reg.gain[c])
                maps += [net.forward(x[i:i + block]) for i in range(0, T, block)]
            hm = torch.cat(maps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    N, K, h, w = hm.shape
    idx = ref.first_max(hm)
    conf = hm.reshape(N, K, h * w).max(dim=-1).values
    rows = (idx // w).cpu().numpy().astype(np.float32) / np.float32(h)
    cols = (idx % w).cpu().numpy().astype(np.float32) / np.float32(w)
    pts = np.stack([rows, cols], axis=-1).reshape(C, T, K, 2)
    off = np.stack([reg.dy.astype(np.float64) / H,
                    np.where(flip, -1.0, 1.0) * reg.dx.astype(np.float64) / W], axis=-1)
    points2d = pts + off[:, None, None, :]
    return Result(points2d, conf.cpu().numpy().reshape(C, T, K, 1), hm)
