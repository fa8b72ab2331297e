"""Persistence, file discovery and media ingest: jax-free copies of
``deepfly3d_tpu/io`` with the same on-disk formats."""

from deepfly3d_torch.io.discovery import (
    construct_image_name,
    get_max_img_id,
    parse_img_name,
    parse_vid_name,
)
from deepfly3d_torch.io.result_schema import load_result, result_filename, save_result
from deepfly3d_torch.io.posedb import PoseDB

__all__ = [
    "construct_image_name",
    "get_max_img_id",
    "parse_img_name",
    "parse_vid_name",
    "load_result",
    "save_result",
    "result_filename",
    "PoseDB",
]
