"""The bundled fly recording: 15 frames of 7 cameras at 480x960, the JPEGs of
``tests/data/reference`` (``camera_{c}_img_{t}.jpg``), decoded to RGB."""

from __future__ import annotations

import hashlib
import os
from concurrent import futures

import numpy as np

RECORDING = os.path.join("tests", "data", "reference")
FRAMES, CAMERAS = 15, 7


def _paths(root: str):
    return [os.path.join(root, RECORDING, f"camera_{c}_img_{t}.jpg")
            for t in range(FRAMES) for c in range(CAMERAS)]


def load(root: str) -> np.ndarray:
    """-> (15, 7, 480, 960, 3) uint8 RGB."""
    import cv2

    def read(p):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(p)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    with futures.ThreadPoolExecutor(max_workers=4) as pool:
        frames = list(pool.map(read, _paths(root)))
    return np.stack(frames).reshape(FRAMES, CAMERAS, *frames[0].shape)


def digest(root: str) -> str:
    """sha256 over the JPEG files, in the order they are read."""
    h = hashlib.sha256()
    for p in _paths(root):
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()
