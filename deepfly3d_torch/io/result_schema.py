"""The ``df3d_result_*.pkl`` schema (a copy of ``deepfly3d_tpu/io/result_schema.py``).

A pickle written by either package loads in the other with equal arrays.

Bit-compatible with the reference output (reference df3d/core.py:326-330 for
the path-mangled filename, 349-369 for the key set) so the original GUI and
analysis notebooks keep working:

* ``points2d``          (C, T, J, 2) float64, normalized (row, col) in [0, 1]
* ``points3d``          (T, J, 3) after procrustes
* ``points3d_wo_procrustes`` (T, J, 3) raw triangulation
* ``0..C-1``            per-camera dicts {R (3,3), tvec (3,), intr (3,3), distort (5,)}
* ``camera_ordering``   (C,) int
* ``heatmap_confidence`` (C, T, J//2, 1) unnormalized heatmap maxima
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np


def result_filename(input_folder: str) -> str:
    """`df3d_result_{input path with / -> _}.pkl` (reference core.py:326-330)."""
    return "df3d_result_{}.pkl".format(input_folder.replace("/", "_"))


def result_path(output_folder: str, input_folder: str) -> str:
    return os.path.join(output_folder, result_filename(input_folder))


def save_result(
    path: str,
    points2d: np.ndarray,
    camera_ordering: np.ndarray,
    heatmap_confidence: Optional[np.ndarray],
    calib: Optional[Dict[int, dict]] = None,
    points3d: Optional[np.ndarray] = None,
    points3d_wo_procrustes: Optional[np.ndarray] = None,
) -> None:
    out: dict = {}
    if calib is not None:
        for cam_id, cam in calib.items():
            out[int(cam_id)] = {
                "R": np.asarray(cam["R"], dtype=np.float64),
                "tvec": np.asarray(cam["tvec"], dtype=np.float64),
                "distort": np.asarray(cam["distort"], dtype=np.float64),
                "intr": np.asarray(cam["intr"], dtype=np.float64),
            }
    out["points2d"] = np.asarray(points2d)
    if points3d is not None:
        out["points3d"] = np.asarray(points3d)
    if points3d_wo_procrustes is not None:
        out["points3d_wo_procrustes"] = np.asarray(points3d_wo_procrustes)
    out["camera_ordering"] = np.asarray(camera_ordering)
    out["heatmap_confidence"] = (
        np.asarray(heatmap_confidence) if heatmap_confidence is not None else None
    )
    with open(path, "wb") as f:
        pickle.dump(out, f)


def load_result(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def extract_calib(result: dict) -> Dict[int, dict]:
    """Harvest integer camera keys from a result/calib dict.

    The reference CameraNetwork accepts either a bare calib dict or a whole
    df3d_result dict (reference core.py:120-126) — integer keys are cameras.
    """
    return {
        int(k): v
        for k, v in result.items()
        if isinstance(k, (int, np.integer)) and isinstance(v, dict)
    }
