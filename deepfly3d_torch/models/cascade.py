"""Decode and 19->38 assembly on the device (subset of the JAX cascade module).

Counterpart of ``deepfly3d_tpu/models/cascade.py::_decode`` and
``_assemble38``, which the golden pipeline shares with the cascade; the
rest of the cascade (leave-one-out repair) is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from deepfly3d_torch.models.decode import decode_argmax


def _decode(heatmaps: torch.Tensor):
    """(N, H, W, K) -> pts (N, K, 2) normalized (row, col), conf (N, K, 1)."""
    return decode_argmax(heatmaps)


def _assemble38(pts19: torch.Tensor, order: Sequence[int], left_cams: torch.Tensor,
                right_cams: torch.Tensor, K: int) -> torch.Tensor:
    """(C, T, 19, 2) -> (C, T, 38, 2), the reference's assembly incl. the
    flip artifact (unobserved right-side entries become col = 1.0)."""
    C, T = pts19.shape[:2]
    p38 = torch.zeros((C, T, 2 * K, 2), dtype=torch.float32, device=pts19.device)
    p38[left_cams, :, :K] = pts19[left_cams]
    p38[right_cams, :, K:] = pts19[right_cams]
    p38[int(order[2]), :, 15:] = 0.0
    p38[int(order[4]), :, K + 15:] = 0.0
    p38[right_cams, ..., 1] = 1.0 - p38[right_cams, ..., 1]
    return p38
