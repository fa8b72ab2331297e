"""The 2D->3D call written out plainly: what the benchmark holds the program to.

One chunk of T frames of C cameras, (T, C, H, W, 3) uint8, goes through

1. the rig registration: per camera, the frames' row and column intensity
   profiles (means over the chunk, the channels and the other axis)
   correlated against the rig template's zero-mean profiles over integer
   offsets in [-8, 8], the first best offset taken, and the gain as the
   ratio of mean intensities, 1 inside a +-1.5% dead zone;
2. the frames rolled back by the offsets, /255, the right-side cameras
   flipped left-right, PyTorch's antialiased bilinear resize to the
   network's input, times 1/gain;
3. the stacked hourglass (``hourglass.py``), the last stack's heatmaps;
4. per heatmap and joint the first maximal cell, (row / h, col / w), and
   the maximum as the confidence;
5. the 19 -> 38 assembly of DeepFly3D (cameras at ordering positions 0-2
   give joints 0-18, positions 4-6 joints 19-37, position 2 drops joints
   15-18 and position 4 joints 34-37, the right side's columns mirrored);
6. the homogeneous DLT of every joint seen by two cameras or more, the
   null vector of its stacked equations by a float64 SVD (zero for the
   others);

and the points go out in the provided frame (offset by the registration
wherever a point is observed).  Every product is float32 with TF32 off
unless ``tf32`` is asked for (the control).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

RADIUS = 8
DEAD_ZONE = 0.015


class Rig(NamedTuple):
    """What the call needs beside the frames and the network."""

    row_profile: np.ndarray        # (C, H) template
    col_profile: np.ndarray        # (C, W)
    mean: np.ndarray               # (C,)
    order: np.ndarray              # camera ordering, (C,)
    R: np.ndarray                  # (C, 3, 3)
    tvec: np.ndarray               # (C, 3)
    intr: np.ndarray               # (C, 3, 3)
    input_shape: tuple             # (h, w) of the network input


def _best_offset(p: np.ndarray, q: np.ndarray) -> int:
    """The first k in [-R, R] maximising sum_i p[i] * (q - mean q)[(i - k) mod L]."""
    q = q - q.mean()
    scores = [float(np.dot(p, np.roll(q, k))) for k in range(-RADIUS, RADIUS + 1)]
    return int(np.argmax(scores)) - RADIUS


def register(frames: torch.Tensor, rig: Rig):
    """-> dy (C,), dx (C,) int64 numpy, gain (C,) float64."""
    T, C, H, W, _ = frames.shape
    sums = torch.zeros((C, H, W), dtype=torch.int64, device=frames.device)
    for t in range(T):
        sums += frames[t].sum(dim=-1, dtype=torch.int64)
    sums = sums.cpu().numpy().astype(np.float64) / (3 * T)
    dy = np.array([_best_offset(sums[c].mean(axis=1), rig.row_profile[c].astype(np.float64))
                   for c in range(C)])
    dx = np.array([_best_offset(sums[c].mean(axis=0), rig.col_profile[c].astype(np.float64))
                   for c in range(C)])
    gain = sums.mean(axis=(1, 2)) / rig.mean.astype(np.float64)
    gain = np.where(np.abs(gain - 1.0) <= DEAD_ZONE, 1.0, gain)
    return dy, dx, gain


def preprocess(frames: torch.Tensor, dy, dx, gain, rig: Rig) -> torch.Tensor:
    """(T, C, H, W, 3) uint8 -> the network input (T*C, 3, h, w) float32, frames-major."""
    T, C = frames.shape[:2]
    flip = np.zeros(C, bool)
    flip[rig.order[4:]] = True
    out = []
    for c in range(C):
        x = torch.roll(frames[:, c], shifts=(-int(dy[c]), -int(dx[c])), dims=(1, 2))
        x = x.permute(0, 3, 1, 2).float() / 255.0
        if flip[c]:
            x = x.flip(3)
        x = F.interpolate(x, size=tuple(rig.input_shape), mode="bilinear",
                          align_corners=False, antialias=True)
        out.append(x * np.float32(1.0 / gain[c]))
    return torch.stack(out, dim=1).reshape(T * C, 3, *rig.input_shape)


def first_max(heatmaps: torch.Tensor) -> torch.Tensor:
    """The first flat index of the maximum per (N, K), whatever the backend's argmax does on ties."""
    N, K, h, w = heatmaps.shape
    flat = heatmaps.reshape(N, K, h * w)
    top = flat.max(dim=-1, keepdim=True).values
    pos = torch.arange(h * w, device=flat.device).expand_as(flat)
    return torch.where(flat == top, pos, h * w).min(dim=-1).values


def assemble(pts19: np.ndarray, order: Sequence[int]) -> np.ndarray:
    """(C, T, 19, 2) float32 -> (C, T, 38, 2) float32."""
    C, T, K, _ = pts19.shape
    left, right = np.asarray(order[:3]), np.asarray(order[4:])
    p38 = np.zeros((C, T, 2 * K, 2), np.float32)
    p38[left, :, :K] = pts19[left]
    p38[right, :, K:] = pts19[right]
    p38[order[2], :, 15:K] = 0.0
    p38[order[4], :, K + 15:] = 0.0
    p38[right, ..., 1] = np.float32(1.0) - p38[right, ..., 1]
    return p38


def observed(p38: np.ndarray) -> np.ndarray:
    """Real observations: row != 0, col != 0 and col != 1."""
    return (p38[..., 0] != 0) & (p38[..., 1] != 0) & (p38[..., 1] != 1)


def offsets(dy, dx, image_hw) -> np.ndarray:
    """(C, 2) float32: the registration's shift as normalised (row, col)."""
    H, W = image_hw
    return np.stack([np.float32(dy) / np.float32(H), np.float32(dx) / np.float32(W)],
                    axis=-1).astype(np.float32)


def dlt_equations(p38: np.ndarray, rig: Rig, image_hw):
    """Canonical (C, T, J, 2) normalised points -> ((T, J, 2C, 4) float64 DLT
    equations, x rows then y rows, an unseen camera's rows zero; (T, J) mask
    of the points that two cameras or more see)."""
    H, W = image_hw
    P = rig.intr.astype(np.float64) @ np.concatenate(
        [rig.R.astype(np.float64), rig.tvec.astype(np.float64)[..., None]], axis=-1)
    x = p38[..., 1].astype(np.float64) * W                    # (C, T, J)
    y = p38[..., 0].astype(np.float64) * H
    seen = observed(p38)
    rows_x = x[..., None] * P[:, None, None, 2] - P[:, None, None, 0]
    rows_y = y[..., None] * P[:, None, None, 2] - P[:, None, None, 1]
    A = np.concatenate([rows_x, rows_y], axis=0) * np.concatenate([seen, seen])[..., None]
    return A.transpose(1, 2, 0, 3), seen.sum(axis=0) >= 2


def triangulate(p38: np.ndarray, rig: Rig, image_hw):
    """Canonical (C, T, J, 2) normalised points -> ((T, J, 3) float64 points,
    (T, J) separation): each point the null vector of its DLT equations,
    zero where fewer than two cameras see it; the separation is the ratio
    of the equations' second-smallest singular value to the smallest, the
    margin by which the null vector is determined (infinite for an unseen
    point)."""
    A, valid = dlt_equations(p38, rig, image_hw)
    _, s, vt = np.linalg.svd(A)                               # (T, J, 2C, 4)
    X = vt[..., -1, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = X[..., :3] / X[..., 3:]
        separation = np.where(valid, s[..., 2] / s[..., 3], np.inf)
    return np.where(valid[..., None], out, 0.0), separation


def residual_excess(p38: np.ndarray, points3d: np.ndarray, rig: Rig, image_hw) -> np.ndarray:
    """(T, J): how far the DLT residual of the given 3D points, |A (X, 1)| /
    |(X, 1)|, lies above the least that the equations of the canonical 2D
    points allow (their smallest singular value), over the gap to the
    second-smallest: 0 at the least-squares point, about 1 for a point as
    far off as the second singular direction; 0 where fewer than two
    cameras see the point."""
    A, valid = dlt_equations(p38, rig, image_hw)
    s = np.linalg.svd(A, compute_uv=False)
    v = np.concatenate([points3d.astype(np.float64), np.ones(points3d.shape[:-1] + (1,))], -1)
    r = np.linalg.norm((A @ v[..., None])[..., 0], axis=-1) / np.linalg.norm(v, axis=-1)
    gap = np.maximum(s[..., 2] - s[..., 3], 1e-12 * s[..., 2] + 1e-300)
    return np.where(valid, (r - s[..., 3]) / gap, 0.0)


class Result(NamedTuple):
    """The reference's call on one chunk, and what judging needs of it."""

    points3d: np.ndarray           # (T, 38, 3) float64
    points2d: np.ndarray           # (C, T, 38, 2) float32, provided frame
    conf: np.ndarray               # (C, T, 19, 1) float32
    heatmaps: torch.Tensor         # (T*C, K, h, w) float32, on the device
    dy: np.ndarray
    dx: np.ndarray
    gain: np.ndarray


def run(frames: torch.Tensor, net, rig: Rig, image_hw, block: int = 32,
        tf32: bool = False) -> Result:
    """The call on one chunk (T, C, H, W, 3) uint8, the network in blocks of
    ``block`` images."""
    T, C = frames.shape[:2]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            dy, dx, gain = register(frames, rig)
            x = preprocess(frames, dy, dx, gain, rig)
            hm = torch.cat([net.forward(x[i:i + block]) for i in range(0, len(x), block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    N, K, h, w = hm.shape
    idx = first_max(hm)
    conf = hm.reshape(N, K, h * w).max(dim=-1).values
    rows = (idx // w).cpu().numpy().astype(np.float32) / np.float32(h)
    cols = (idx % w).cpu().numpy().astype(np.float32) / np.float32(w)
    pts19 = np.stack([rows, cols], axis=-1).reshape(T, C, K, 2).transpose(1, 0, 2, 3)
    canon = assemble(np.ascontiguousarray(pts19), rig.order)
    points3d = triangulate(canon, rig, image_hw)[0]
    p38 = canon + observed(canon)[..., None] * offsets(dy, dx, image_hw)[:, None, None, :]
    conf = conf.cpu().numpy().reshape(T, C, K, 1).transpose(1, 0, 2, 3)
    return Result(points3d, p38.astype(np.float32), np.ascontiguousarray(conf), hm,
                  dy, dx, gain)


def load_rig(cfg: Dict, root: str) -> Rig:
    """The template, ordering and calibration a configuration names, read
    from the repository's data files."""
    import os
    import pickle

    with np.load(os.path.join(root, cfg["rig_template"])) as z:
        row, col, mean = (np.asarray(z[k], np.float32) for k in ("row_profile", "col_profile",
                                                               "mean"))
    with open(os.path.join(root, cfg["calib"]), "rb") as f:
        calib = pickle.load(f)
    C = cfg["num_cameras"]
    R, tvec, intr = (np.stack([np.asarray(calib[c][k], np.float32) for c in range(C)])
                     for k in ("R", "tvec", "intr"))
    return Rig(row, col, mean, np.asarray(cfg["camera_ordering"]), R, tvec, intr,
               tuple(cfg["spec"]["input_shape"]))
