"""The one traffic generator: a pool of recording chunks drawn from the seed.

A traffic mix is a JSON file under ``traffic/`` whose parameters this module
reads:

* ``source``: the frames, ``sources/<source>.py`` (``load(root)`` -> (n, C,
  H, W, 3) uint8, ``digest(root)``); ``fly_recording`` where it names none;
* ``T``: frames per chunk, every camera's (one call's input);
* ``chunks``: chunks in the pool, which the calls take round robin;
* ``pool``: ``"device"`` (the chunks in device memory), ``"pinned"`` (in
  pinned host memory, as a decoder stages frames) or ``"host"`` (pageable
  numpy, laid out camera-major as a JPEG or video decoder yields a
  recording's frames, seen as (T, C, H, W, 3));
* ``max_roll_px``: cameras are rolled by integers in [-max_roll_px,
  max_roll_px] on both axes (a rig that drifted);
* ``gain``: [low, high], the cameras' brightness factor;
* ``drift``: ``"chunk"`` (one roll and gain per camera and chunk, where the
  mix names none) or ``"recording"`` (one per camera for the whole pool:
  the chunks are segments of one recording);
* ``noise_levels``: every pixel gets a uniform integer in [-n, n].

Each chunk is one recording segment: consecutive frames of the source, read
back and forth from a seeded start.  Every seed gives the same sizes; it
draws the starts, rolls, gains and noise.  The noise is drawn on the device
by a ``torch.Generator``.
"""

from __future__ import annotations

import hashlib
import os
from typing import List

import numpy as np
import torch

import named

SOURCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sources")
DEFAULT_SOURCE = "fly_recording"


def source(mix: dict):
    """The frame source module that a traffic mix names."""
    return named.load(SOURCES, mix.get("source", DEFAULT_SOURCE))


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    text = ":".join(str(v) for v in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _pingpong(i: np.ndarray, n: int) -> np.ndarray:
    period = 2 * n - 2
    i = i % period
    return np.where(i < n, i, period - i)


def make_pool(recording: torch.Tensor, mix: dict, seed: int) -> List:
    """-> ``mix["chunks"]`` chunks (T, C, H, W, 3) uint8: tensors on the
    recording's device or in pinned host memory, or host numpy arrays."""
    dev = recording.device
    n_rec, C = recording.shape[:2]
    T = int(mix["T"])
    lo, hi = mix["gain"]
    r, n = int(mix["max_roll_px"]), int(mix["noise_levels"])
    drift = mix.get("drift", "chunk")
    if drift not in ("chunk", "recording"):
        raise ValueError(f"drift {drift!r}: chunk or recording")
    if mix["pool"] not in ("device", "pinned", "host"):
        raise ValueError(f"pool {mix['pool']!r}: device, pinned or host")
    if drift == "recording":
        rng = np.random.default_rng(sub_seed(seed, "recording"))
        rec_rolls = rng.integers(-r, r + 1, size=(C, 2))
        rec_gains = rng.uniform(lo, hi, size=C).astype(np.float32)
    pool = []
    for k in range(int(mix["chunks"])):
        rng = np.random.default_rng(sub_seed(seed, "chunk", k))
        frames = _pingpong(rng.integers(0, 2 * n_rec - 2) + np.arange(T), n_rec)
        rolls = rng.integers(-r, r + 1, size=(C, 2))
        gains = rng.uniform(lo, hi, size=C).astype(np.float32)
        if drift == "recording":
            rolls, gains = rec_rolls, rec_gains
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
        elif mix["pool"] == "host":
            chunk = chunk.transpose(0, 1).contiguous().cpu().numpy().transpose(1, 0, 2, 3, 4)
        pool.append(chunk)
    return pool
