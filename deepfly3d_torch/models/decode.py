"""Heatmap decoding and the 19->38 joint postprocess.

Counterpart of ``deepfly3d_tpu/models/decode.py`` (``decode_argmax``,
``postprocess_points2d``).  The decode contract: ``points2d = (argmax_row /
H, argmax_col / W)``, the plain integer argmax over the heatmap (first index
on ties), normalised by the heatmap shape; the confidence is the
unnormalised heatmap maximum.  On a card the decode runs in
``csrc/decode.cu``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from deepfly3d_torch.ops.kernels import decode_heatmaps


def decode_argmax(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, K) heatmaps -> normalized (row, col) (N, K, 2) + conf (N, K, 1)."""
    return decode_heatmaps(heatmaps.float().contiguous())


def postprocess_points2d(points2d_19: np.ndarray, camera_ordering: Sequence[int],
                         num_joints: int = 38) -> np.ndarray:
    """(C, T, 19, 2) per-camera predictions -> (C, T, 38, 2) assembled pose.

    Same semantics as the JAX package (reference df3d/core.py:189-203):
    ordering positions 0-2 fill joints 0:19 and 4-6 fill 19:38, position 3
    is discarded; position 2 zeroes joints 15:, position 4 joints 19+15:;
    right-side cameras get col <- 1 - col, which turns their zero entries
    into exactly 1.0 (the flip artifact in the golden data).
    """
    points2d_19 = np.asarray(points2d_19)
    order = np.asarray(camera_ordering)
    C, T = points2d_19.shape[:2]
    side = points2d_19.shape[2]
    out = np.zeros((C, T, num_joints, 2), dtype=np.float64)
    out[order[:3], :, :side] = points2d_19[order[:3]]
    out[order[4:], :, side:] = points2d_19[order[4:]]
    out[order[2], :, 15:] = 0
    out[order[4], :, side + 15:] = 0
    for pos in (4, 5, 6):
        out[order[pos], ..., 1] = 1 - out[order[pos], ..., 1]
    return out
