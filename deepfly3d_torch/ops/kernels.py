"""Level merge and heatmap decode: plain versions and CUDA wrappers.

Counterpart of ``deepfly3d_tpu/ops/pallas/kernels.py``:

* ``upsample2x_add`` — nearest-2x upsample of the inner hourglass level
  added to the skip branch (``csrc/upsample_add.cu``);
* ``decode_heatmaps`` — per image and joint, the heatmap maximum and its
  first-index argmax as normalized (row, col) (``csrc/decode.cu``).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deepfly3d_torch.ops import _build


def _check_cuda(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")


# ------------------------------------------------------- upsample 2x + add


def upsample2x_add_plain(inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) inner + (N, 2H, 2W, C) skip -> (N, 2H, 2W, C)."""
    n, h, w, c = inner.shape
    up = inner[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return skip + up.reshape(n, 2 * h, 2 * w, c)


def upsample2x_add(inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample of ``inner`` plus ``skip``, float32 NHWC.

    Launches ``csrc/upsample_add.cu`` on CUDA tensors (counted in
    ``upsample2x_add.launches``) or raises; plain version on CPU tensors.
    """
    if inner.dim() != 4 or skip.dim() != 4:
        raise ValueError("inner and skip must be NHWC")
    n, h, w, c = inner.shape
    if tuple(skip.shape) != (n, 2 * h, 2 * w, c):
        raise ValueError(f"skip shape {tuple(skip.shape)} != {(n, 2 * h, 2 * w, c)}")
    if inner.device.type == "cpu":
        return upsample2x_add_plain(inner, skip)
    if inner.device.type != "cuda":
        raise ValueError(f"upsample2x_add runs on cuda or cpu, not {inner.device}")
    _check_cuda("inner", inner, inner.device)
    _check_cuda("skip", skip, inner.device)
    out = torch.empty_like(skip)
    if out.numel() == 0:
        return out
    fn = _build.library("upsample_add").df3d_upsample2x_add
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(inner.data_ptr(), skip.data_ptr(), out.data_ptr(), n, h, w, c,
            torch.cuda.current_stream(inner.device).cuda_stream)
    _build.check(rc, "upsample2x_add kernel")
    upsample2x_add.launches += 1
    return out


upsample2x_add.launches = 0


# ------------------------------------------------------------ heatmap decode


def decode_heatmaps_plain(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, K) -> ((N, K, 2) normalized (row, col), (N, K, 1) max).

    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``.
    """
    n, h, w, k = heatmaps.shape
    flat = heatmaps.float().permute(0, 3, 1, 2).reshape(n, k, h * w)
    idx = torch.argmax(flat, dim=-1)
    conf = torch.amax(flat, dim=-1, keepdim=True)
    row = torch.div(idx, w, rounding_mode="floor").float() / h
    col = (idx % w).float() / w
    return torch.stack([row, col], dim=-1), conf


def decode_heatmaps(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax decode of (N, H, W, K) float32 heatmaps, first index on ties.

    Launches ``csrc/decode.cu`` on a CUDA tensor (counted in
    ``decode_heatmaps.launches``) or raises; plain version on a CPU tensor.
    """
    if heatmaps.dim() != 4:
        raise ValueError("heatmaps must be (N, H, W, K)")
    n, h, w, k = heatmaps.shape
    if heatmaps.device.type == "cpu":
        return decode_heatmaps_plain(heatmaps)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"decode_heatmaps runs on cuda or cpu, not {heatmaps.device}")
    _check_cuda("heatmaps", heatmaps, heatmaps.device)
    if not 1 <= k <= 1024 or h * w < 1:
        raise ValueError(f"decode kernel needs 1 <= K <= 1024 and H*W >= 1, got {tuple(heatmaps.shape)}")
    pts = torch.empty((n, k, 2), device=heatmaps.device, dtype=torch.float32)
    conf = torch.empty((n, k, 1), device=heatmaps.device, dtype=torch.float32)
    if n == 0:
        return pts, conf
    fn = _build.library("decode").df3d_decode_heatmaps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(heatmaps.data_ptr(), pts.data_ptr(), conf.data_ptr(), n, h, w, k,
            torch.cuda.current_stream(heatmaps.device).cuda_stream)
    _build.check(rc, "decode kernel")
    decode_heatmaps.launches += 1
    return pts, conf


decode_heatmaps.launches = 0
