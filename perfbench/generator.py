"""The one traffic generator: a pool of recording chunks drawn from the seed.

A traffic mix is a JSON file under ``traffic/`` whose parameters this module
reads:

* ``T``: frames per chunk, every camera's (one call's input);
* ``chunks``: chunks in the pool, which the calls take round robin;
* ``pool``: ``"device"`` (the chunks in device memory) or ``"pinned"``
  (in pinned host memory, as a decoder stages frames);
* ``max_roll_px``: each chunk's cameras are rolled by integers in
  [-max_roll_px, max_roll_px] on both axes (a rig that drifted);
* ``gain``: [low, high], each chunk's cameras' brightness factor;
* ``noise_levels``: every pixel gets a uniform integer in [-n, n].

Each chunk is one recording segment: consecutive frames of the bundled
recording (15 frames of 7 cameras), read back and forth from a seeded
start.  Every seed gives the same sizes; it draws the starts, rolls, gains
and noise.  The noise is drawn on the device by a ``torch.Generator``.
"""

from __future__ import annotations

import hashlib
import os
from concurrent import futures
from typing import List

import numpy as np
import torch

RECORDING = os.path.join("tests", "data", "reference")
RECORDING_T, RECORDING_C = 15, 7


def load_recording(root: str) -> np.ndarray:
    """The bundled recording as (15, 7, 480, 960, 3) uint8 RGB."""
    import cv2

    paths = [os.path.join(root, RECORDING, f"camera_{c}_img_{t}.jpg")
             for t in range(RECORDING_T) for c in range(RECORDING_C)]

    def read(p):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(p)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    with futures.ThreadPoolExecutor(max_workers=4) as pool:
        frames = list(pool.map(read, paths))
    return np.stack(frames).reshape(RECORDING_T, RECORDING_C, *frames[0].shape)


def recording_digest(root: str) -> str:
    """sha256 over the recording's JPEG files, in the order they are read."""
    h = hashlib.sha256()
    for t in range(RECORDING_T):
        for c in range(RECORDING_C):
            with open(os.path.join(root, RECORDING, f"camera_{c}_img_{t}.jpg"), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    text = ":".join(str(v) for v in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _pingpong(i: np.ndarray, n: int) -> np.ndarray:
    period = 2 * n - 2
    i = i % period
    return np.where(i < n, i, period - i)


def make_pool(recording: torch.Tensor, mix: dict, seed: int) -> List[torch.Tensor]:
    """-> ``mix["chunks"]`` chunks (T, C, H, W, 3) uint8 on the recording's
    device, or in pinned host memory for ``pool == "pinned"``."""
    dev = recording.device
    n_rec, C = recording.shape[:2]
    T = int(mix["T"])
    lo, hi = mix["gain"]
    r, n = int(mix["max_roll_px"]), int(mix["noise_levels"])
    pool = []
    for k in range(int(mix["chunks"])):
        rng = np.random.default_rng(sub_seed(seed, "chunk", k))
        frames = _pingpong(rng.integers(0, 2 * n_rec - 2) + np.arange(T), n_rec)
        rolls = rng.integers(-r, r + 1, size=(C, 2))
        gains = rng.uniform(lo, hi, size=C).astype(np.float32)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "noise", k))
        chunk = torch.empty((T,) + tuple(recording.shape[1:]), dtype=torch.uint8, device=dev)
        gain_t = torch.as_tensor(gains, device=dev)[:, None, None, None]
        for t in range(T):
            x = recording[int(frames[t])].float() * gain_t
            x = torch.round(x) + torch.randint(-n, n + 1, x.shape, generator=gen, device=dev,
                                               dtype=torch.int16).float()
            x = x.clamp_(0, 255).to(torch.uint8)
            for c in range(C):
                x[c] = torch.roll(x[c], shifts=(int(rolls[c, 0]), int(rolls[c, 1])), dims=(0, 1))
            chunk[t] = x
        if mix["pool"] == "pinned":
            chunk = chunk.cpu().pin_memory() if dev.type == "cuda" else chunk.cpu()
        elif mix["pool"] != "device":
            raise ValueError(f"pool {mix['pool']!r}: device or pinned")
        pool.append(chunk)
    return pool
