"""Configuration of the fly rig, the fields the port's main path reads.

A jax-free copy of the part of ``deepfly3d_tpu/config.py`` (``Config`` /
``NetworkConfig``) that the golden 2D->3D path uses: camera count, which
cameras are fed flipped, the network input shape and the default
checkpoint and rig template.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_DIR = os.path.join(_ROOT, "weights")
DATA_DIR = os.path.join(_ROOT, "data")


@dataclasses.dataclass
class NetworkConfig:
    """Stacked-hourglass deployment settings."""

    input_shape: Tuple[int, int] = (256, 512)    # (h, w) network input
    checkpoint: str = os.path.join(WEIGHTS_DIR, "hourglass_fly.npz")


@dataclasses.dataclass
class Config:
    num_cameras: int = 7
    flip_cameras: Tuple[int, ...] = (4, 5, 6)    # fed horizontally flipped
    image_hw: Tuple[int, int] = (480, 960)       # (height, width) of a frame
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    calib_prior_path: str = os.path.join(DATA_DIR, "calib.pkl")
    rig_template_path: str = os.path.join(WEIGHTS_DIR, "rig_template_fly.npz")


def fly_config() -> Config:
    return Config()
