"""Rig registration: canonicalize camera frames against the calibration session.

Counterpart of ``deepfly3d_tpu/ops/canonicalize.py`` (building and I/O of
the template, and the batch-level device path).  Per camera, an integer translation (±8 px on both
axes) is found by correlating the batch-averaged row and column intensity
profiles against the rig template's zero-mean profiles, and a global gain
as the mean-intensity ratio, snapped to exactly 1 inside a ±1.5% dead zone.
On un-drifted input the estimates are exact zeros and ones, so the
registration is the bit-exact identity.  2D points go out in the provided
frame (``adjust_points38``); triangulation consumes the canonical points.

The folder and video ingest paths (``models/inference.py``) estimate once per
camera and recording on the host (``estimate_camera_np``, numpy, the JAX
package's own host estimator) and emit raw points in the provided frame
(``adjust_points_raw``).

The frame profiles are summed in integers, one frame at a time, so a batch
of uint8 frames is never copied to float as a whole.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfly3d_torch.ops.geometry import observation_mask

SEARCH_RADIUS = 8          # ± pixels searched, both axes
GAIN_DEAD_ZONE = 0.015     # |gain-1| below this -> identity
MIN_EST_FRAMES = 8         # the ingest paths skip registration below this


class RigTemplate(NamedTuple):
    """Calibration-session statistics per camera: row_profile (C, H),
    col_profile (C, W), mean (C,), float32 numpy."""

    row_profile: np.ndarray
    col_profile: np.ndarray
    mean: np.ndarray

    @property
    def image_hw(self) -> Tuple[int, int]:
        return self.row_profile.shape[1], self.col_profile.shape[1]


def build_template(frames: np.ndarray) -> RigTemplate:
    """(C, T, H, W, 3) uint8 calibration frames -> RigTemplate (the JAX
    package's float64 means, stored as float32)."""
    f = frames.astype(np.float64)
    return RigTemplate(
        row_profile=f.mean(axis=(1, 3, 4)).astype(np.float32),
        col_profile=f.mean(axis=(1, 2, 4)).astype(np.float32),
        mean=f.reshape(f.shape[0], -1).mean(axis=1).astype(np.float32),
    )


def save_template(path: str, tpl: RigTemplate, source: str = "") -> None:
    """Write ``tpl`` as ``load_template`` (in either package) reads it."""
    np.savez(
        path,
        row_profile=tpl.row_profile.astype(np.float32),
        col_profile=tpl.col_profile.astype(np.float32),
        mean=tpl.mean.astype(np.float32),
        source=np.str_(source),
    )


def load_template(path: str) -> RigTemplate:
    with np.load(path) as z:
        return RigTemplate(
            row_profile=np.asarray(z["row_profile"], np.float32),
            col_profile=np.asarray(z["col_profile"], np.float32),
            mean=np.asarray(z["mean"], np.float32),
        )


def find_template(checkpoint_path: str) -> Optional[str]:
    """A ``.rig.npz`` sidecar of the checkpoint, else ``rig_template_fly.npz``
    in the checkpoint's directory, else None."""
    sidecar = checkpoint_path + ".rig.npz"
    if os.path.exists(sidecar):
        return sidecar
    shared = os.path.join(os.path.dirname(os.path.abspath(checkpoint_path)),
                          "rig_template_fly.npz")
    return shared if os.path.exists(shared) else None


class TemplateArrays(NamedTuple):
    """Device-ready template: zero-mean profiles and means."""

    row_zm: torch.Tensor          # (C, H) float32, zero-mean per camera
    col_zm: torch.Tensor          # (C, W)
    mean: torch.Tensor            # (C,)
    image_hw: Tuple[int, int]
    radius: int
    gain_dead_zone: float


def _zero_mean(profile: np.ndarray) -> np.ndarray:
    return profile - profile.mean(axis=-1, keepdims=True)


def prepare(tpl: RigTemplate, device, radius: int = SEARCH_RADIUS,
            gain_dead_zone: float = GAIN_DEAD_ZONE) -> TemplateArrays:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return TemplateArrays(put(_zero_mean(tpl.row_profile)),
                          put(_zero_mean(tpl.col_profile)), put(tpl.mean),
                          tpl.image_hw, radius, gain_dead_zone)


def _corr1d_argmax(p: torch.Tensor, q_zm: torch.Tensor, radius: int) -> torch.Tensor:
    """Per camera, the offset k in [-radius, radius] maximising
    sum_i p[i] * q_zm[(i - k) mod L] (first k on ties).  p, q_zm: (C, L)."""
    L = p.shape[-1]
    offs = torch.arange(-radius, radius + 1, device=p.device)
    idx = (torch.arange(L, device=p.device)[None, :] - offs[:, None]) % L
    qs = q_zm[:, idx]                                   # (C, 2R+1, L)
    corr = torch.einsum("cl,ckl->ck", p, qs)
    return offs[corr.argmax(dim=1)].to(torch.int32)


def estimate_tc(frames_tc: torch.Tensor, ta: TemplateArrays):
    """(T, C, H, W, 3) uint8 -> (dy (C,), dx (C,), gain (C,))."""
    T, C, H, W, _ = frames_tc.shape
    acc = torch.zeros((C, H, W), dtype=torch.int64, device=frames_tc.device)
    for t in range(T):
        acc += frames_tc[t].sum(dim=-1, dtype=torch.int32)
    count = 3 * T
    rows = (acc.sum(dim=2).double() / (count * W)).float()  # (C, H)
    cols = (acc.sum(dim=1).double() / (count * H)).float()  # (C, W)
    mean = (acc.sum(dim=(1, 2)).double() / (count * H * W)).float()
    dy = _corr1d_argmax(rows, ta.row_zm, ta.radius)
    dx = _corr1d_argmax(cols, ta.col_zm, ta.radius)
    gain = mean / ta.mean
    gain = torch.where((gain - 1.0).abs() <= ta.gain_dead_zone,
                       torch.ones_like(gain), gain)
    return dy, dx, gain


def apply_shift_tc(frames_tc: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Roll every camera's frames by (-dy, -dx): (T, C, H, W, 3) uint8 -> same.

    Two integer gathers; with zero shifts they are identity permutations.
    """
    T, C, H, W, _ = frames_tc.shape
    dev = frames_tc.device
    cam = torch.arange(C, device=dev)
    ridx = (torch.arange(H, device=dev)[None, :] + dy.long()[:, None]) % H   # (C, H)
    cidx = (torch.arange(W, device=dev)[None, :] + dx.long()[:, None]) % W   # (C, W)
    x = frames_tc[:, cam[:, None], ridx]                                 # (T, C, H, W, 3)
    return x[:, cam[:, None, None], torch.arange(H, device=dev)[None, :, None],
             cidx[:, None, :]]


def gain_correction(gain: torch.Tensor) -> torch.Tensor:
    """(C,) gain -> (C,) float32 factor, exactly 1 where the gain was snapped."""
    return torch.where(gain == 1.0, torch.ones_like(gain), 1.0 / gain).float()


def adjust_points38(p38: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                    image_hw: Tuple[int, int]) -> torch.Tensor:
    """Canonical (C, T, 38, 2) points -> provided-frame coordinates.

    Entries holding the "unobserved" encodings (exact zeros, col == 1.0)
    are left as they are.
    """
    H, W = image_hw
    off = torch.stack([dy.float() / H, dx.float() / W], dim=-1)    # (C, 2)
    vis = observation_mask(p38).to(p38.dtype)                      # (C, T, 38)
    return p38 + vis[..., None] * off[:, None, None, :]


# ---------------------------------------------------------------------------
# Host side of the folder/video ingest paths: estimation once per camera and
# recording (numpy), application per batch (in the preprocess kernel).


def _corr1d_argmax_np(p: np.ndarray, q_zm: np.ndarray, radius: int) -> int:
    """``_corr1d_argmax`` for one camera: p, q_zm (L,) numpy."""
    L = p.shape[-1]
    offs = np.arange(-radius, radius + 1)
    idx = (np.arange(L)[None, :] - offs[:, None]) % L
    return int(offs[np.argmax(q_zm[idx] @ p)])


def estimate_camera_np(frames_cam: np.ndarray, tpl: RigTemplate, cam: int,
                       radius: int = SEARCH_RADIUS,
                       gain_dead_zone: float = GAIN_DEAD_ZONE) -> Tuple[int, int, float]:
    """(T, H, W, 3) uint8 frames of one camera -> (dy, dx, gain).

    The profiles in float32 as the JAX host estimator forms them, the gain as
    a float64 mean ratio, snapped to 1.0 inside the dead zone.
    """
    p = frames_cam.astype(np.float32).mean(axis=(0, 3))
    dy = _corr1d_argmax_np(p.mean(axis=1), _zero_mean(tpl.row_profile[cam]), radius)
    dx = _corr1d_argmax_np(p.mean(axis=0), _zero_mean(tpl.col_profile[cam]), radius)
    gain = float(frames_cam.astype(np.float64).mean() / tpl.mean[cam])
    if abs(gain - 1.0) <= gain_dead_zone:
        gain = 1.0
    return dy, dx, gain


def apply_np(frames: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Roll (N, H, W, 3) frames of one camera back to canonical (by (-dy, -dx))."""
    if dy == 0 and dx == 0:
        return frames
    return np.roll(np.roll(frames, -dy, axis=1), -dx, axis=2)


def adjust_points_raw(pts: np.ndarray, dy: np.ndarray, dx: np.ndarray,
                      flip: np.ndarray, image_hw: Tuple[int, int]) -> np.ndarray:
    """Raw (N, K, 2) network-frame points -> provided-frame coordinates.

    Flipped images are still in the flipped frame, where the offset is
    (dy/H, -dx/W); unflipped ones get (dy/H, dx/W).  Every raw entry is an
    observation, so nothing is masked.
    """
    H, W = image_hw
    off = np.stack(
        [np.asarray(dy, np.float64) / H,
         np.where(np.asarray(flip, bool), -1.0, 1.0) * np.asarray(dx, np.float64) / W],
        axis=-1,
    )                                                   # (N, 2)
    return pts + off[:, None, :]
