"""Capture profiles (the fly rig, the h36m human rig): the fields the port's paths read.

A jax-free copy of the part of ``deepfly3d_tpu/config.py`` (``Config`` /
``NetworkConfig``, ``fly_config`` / ``h36m_config``) that the 2D->3D
pipelines, ``Core``, ``cli`` and ``viz`` use: camera count and which cameras
are fed flipped, the skeleton, the frame shape, the network input shape, the
default checkpoint and rig template, the calibration prior, the Procrustes
template, the streaming threshold, the pictorial-structures hyperparameters
(``BeliefPropagationConfig``), the error-navigation threshold and the
overlay style.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from deepfly3d_torch.skeletons import fly, h36m
from deepfly3d_torch.skeletons.skeleton import Skeleton

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_DIR = os.path.join(_ROOT, "weights")
DATA_DIR = os.path.join(_ROOT, "data")


@dataclasses.dataclass
class NetworkConfig:
    """Stacked-hourglass deployment settings."""

    num_predict: int = fly.num_joints // 2       # 19 channels = one body side
    input_shape: Tuple[int, int] = (256, 512)    # (h, w) network input
    checkpoint: str = os.path.join(WEIGHTS_DIR, "hourglass_fly.npz")


@dataclasses.dataclass
class BeliefPropagationConfig:
    """Pictorial-structures MAP hyperparameters (reference df3d/config.py:55-60)."""

    num_peak: int = 10
    upper_bound: int = 200
    alpha_reproj: float = 30.0
    alpha_heatmap: float = 600.0
    alpha_bone: float = 10.0


@dataclasses.dataclass
class Config:
    name: str = "fly"
    num_cameras: int = 7
    skeleton: Skeleton = dataclasses.field(default_factory=lambda: fly.skeleton)
    flip_cameras: Tuple[int, ...] = (4, 5, 6)    # fed horizontally flipped
    image_hw: Tuple[int, int] = (480, 960)       # (height, width) of a frame
    image_shape: Optional[Tuple[int, int]] = None   # (width, height), probed by Core
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    bp: BeliefPropagationConfig = dataclasses.field(default_factory=BeliefPropagationConfig)
    # per-joint reprojection-error threshold in px for error navigation
    reproj_thr_px: float = 40.0
    calib_prior_path: str = os.path.join(DATA_DIR, "calib.pkl")
    rig_template_path: str = os.path.join(WEIGHTS_DIR, "rig_template_fly.npz")
    procrustes_apply: bool = True
    procrustes_template_path: str = DATA_DIR     # dir containing df3d_result*.pkl
    # overlays (viz/plot2d.py): filled circles of radius scatter_r over bones
    # of line_thickness
    line_thickness: int = 5
    scatter_r: int = 8
    # recordings longer than this stream from the camera videos
    # (Core(streaming=None)): at 480x960x3 uint8 the image flow holds
    # ~9.7 MB per 7-camera frame in host memory
    streaming_auto_threshold: int = 512

    @property
    def num_joints(self) -> int:
        return self.skeleton.num_joints


def fly_config() -> Config:
    return Config()


def h36m_config() -> Config:
    """Human3.6M-style 4-camera human profile: four 128-wide stacks, 384x384
    input, 96x96 heatmaps of the 17 joints."""
    return Config(
        name="h36m",
        num_cameras=4,
        skeleton=h36m.skeleton,
        flip_cameras=(),
        image_hw=(1000, 1000),                   # a Human3.6M frame
        # the fly's per-side Procrustes registration does not apply to the
        # human skeleton: the raw triangulated points are the 3D output
        procrustes_apply=False,
        network=NetworkConfig(
            num_predict=h36m.num_joints,
            input_shape=(384, 384),
            checkpoint=os.path.join(WEIGHTS_DIR, "hourglass_h36m.npz"),
        ),
    )
