"""A seeded human recording in Human3.6M's layout: 15 frames of 4 cameras at
1000x1000, made as ``deepfly3d_torch/utils/synthetic.human_frames`` makes
them (a 17-joint rest pose drifting and jittering over the frames, seen by
cameras 90 degrees apart 5 m from it, focal 1400 px, barrel distortion k1
-0.15, each joint a Gaussian blob of 9 px in colour channel j % 3 over
uniform noise in [0, 64)), from the fixed seed ``SEED``, in numpy alone.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

SEED, FRAMES, CAMERAS, SIZE = 0, 15, 4, 1000
FOCAL, DISTANCE, K1 = 1400.0, 5.0, -0.15
SIGMA, NOISE = 9.0, 64

# H3.6M-like rest pose in meters, pelvis at the origin, image-down = +y
POSE = np.array([
    [0.00, 0.00, 0.00], [-0.13, 0.00, 0.00], [-0.13, 0.45, 0.02], [-0.13, 0.88, 0.00],
    [0.13, 0.00, 0.00], [0.13, 0.45, 0.02], [0.13, 0.88, 0.00],
    [0.00, -0.25, 0.00], [0.00, -0.50, 0.00], [0.00, -0.60, 0.00], [0.00, -0.75, 0.02],
    [0.18, -0.50, 0.00], [0.26, -0.26, 0.06], [0.30, -0.03, 0.12],
    [-0.18, -0.50, 0.00], [-0.26, -0.26, 0.06], [-0.30, -0.03, 0.12],
])


def _pixels(points: np.ndarray, cam: int) -> np.ndarray:
    """(..., 3) world points -> (..., 2) distorted pixel (x, y) in camera ``cam``."""
    c, s = np.cos(np.pi / 2 * cam), np.sin(np.pi / 2 * cam)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    Xc = points @ R.T + np.array([0.0, 0.0, DISTANCE])
    x, y = Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2]
    k1, k2, p1, p2, k3 = K1, 0.0, 0.0, 0.0, 0.0
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([FOCAL * xd + 0.0 * yd + SIZE / 2.0, FOCAL * yd + SIZE / 2.0], axis=-1)


@lru_cache(maxsize=1)
def _frames() -> np.ndarray:
    """(15, 4, 1000, 1000, 3) uint8 RGB."""
    rng = np.random.default_rng(SEED)
    drift = np.cumsum(rng.standard_normal((FRAMES, 1, 3)) * 0.02, axis=0)
    points3d = POSE[None] + drift + rng.standard_normal((FRAMES, len(POSE), 3)) * 0.02
    pixels = np.stack([_pixels(points3d, c) for c in range(CAMERAS)])
    frames = rng.integers(0, NOISE, size=(CAMERAS, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    r = int(np.ceil(4 * SIGMA))
    for c in range(CAMERAS):
        for t in range(FRAMES):
            for j, (px, py) in enumerate(pixels[c, t]):
                x0, y0 = int(round(px)), int(round(py))
                ys = np.arange(max(0, y0 - r), min(SIZE, y0 + r + 1))
                xs = np.arange(max(0, x0 - r), min(SIZE, x0 + r + 1))
                blob = np.exp(-((ys[:, None] - py) ** 2 + (xs[None, :] - px) ** 2)
                              / (2 * SIGMA ** 2))
                frames[c, t, ys[:, None], xs[None, :], j % 3] += 230.0 * blob
    out = np.clip(np.rint(frames), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(out.transpose(1, 0, 2, 3, 4))


def load(root: str) -> np.ndarray:
    """-> (15, 4, 1000, 1000, 3) uint8 RGB."""
    del root
    return _frames()


def digest(root: str) -> str:
    """sha256 over the frames' bytes, frame-major."""
    return hashlib.sha256(load(root).tobytes()).hexdigest()
