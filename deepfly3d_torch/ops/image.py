"""Frame preprocessing as two resize matmuls and a low-resolution flip.

Counterpart of ``deepfly3d_tpu/ops/image.py``.  ``jax.image.resize``'s
bilinear resize with antialiasing (a triangle filter widened by the
downscale factor, each output's weights normalised to sum to one) is
linear per axis, so each axis is a dense (out, in) matrix.  The JAX package
extracts it by resizing an identity matrix; the port rebuilds the same
weights in numpy, in float64 as JAX computes them with x64 on, then casts
to float32 (equal to the JAX matrix bit for bit with x64 on, within 6e-8
with x64 off).  ``torch.nn.functional.interpolate(antialias=True)`` uses
another filter and is not a substitute.

    frames_u8 -> einsum(RH/255, x) -> einsum(RW, .) -> flip

/255 is folded into the H matrix, and the flip comes after the resize:
flipping commutes with the symmetric resampling grid.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=16)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of jax.image.resize "bilinear" on one axis."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)            # antialias when downscaling
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    weights = np.maximum(0.0, 1.0 - x / kernel_scale)      # (n_in, n_out)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, 0.0)
    out = weights.T.astype(np.float32)
    out.flags.writeable = False          # shared by every caller of the cache
    return out


def resize_matrices(in_shape: Tuple[int, int], out_shape: Tuple[int, int],
                    device, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (RH (h_out, h_in), RW (w_out, w_in)) float32; ``scale`` folded into RH."""
    rh = _resize_matrix(in_shape[0], out_shape[0]) * np.float32(scale)
    rw = _resize_matrix(in_shape[1], out_shape[1])
    return (torch.from_numpy(np.ascontiguousarray(rh)).to(device),
            torch.from_numpy(np.array(rw)).to(device))


def preprocess_frames(frames_u8: torch.Tensor, flip: torch.Tensor,
                      out_shape: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, 3) uint8 + (N,) bool flip -> (N, h, w, 3) float32.

    Equal, up to the order of the matmul sums, to casting to float, /255,
    flipping where ``flip`` and resizing with jax.image.resize "bilinear".
    """
    n, h_in, w_in, c = frames_u8.shape
    rh, rw = resize_matrices((h_in, w_in), tuple(out_shape), frames_u8.device,
                             scale=1.0 / 255.0)
    x = frames_u8.float()
    x = torch.einsum("oh,nhwc->nowc", rh, x)     # H first: shrinks the tensor
    x = torch.einsum("ow,nhwc->nhoc", rw, x)
    return torch.where(flip.reshape(n, 1, 1, 1), x.flip(2), x)
