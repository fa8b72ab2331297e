"""Frame preprocessing: uint8 -> /255 -> flip -> antialiased bilinear resize.

Counterpart of ``deepfly3d_tpu/ops/image.py``.  ``jax.image.resize``'s
bilinear resize with antialiasing (a triangle filter widened by the
downscale factor, each output's weights normalised to sum to one) is
linear per axis, so each axis is an (out, in) matrix.  The JAX package
extracts it by resizing an identity matrix; the port rebuilds the same
weights in numpy, in float64 as JAX computes them with x64 on, then casts
to float32 (equal to the JAX matrix bit for bit with x64 on, within 6e-8
with x64 off).  ``torch.nn.functional.interpolate(mode="bilinear",
antialias=True, align_corners=False)`` uses the same triangle filter: its
float64 weights cast to float32 equal these, and on float32 NCHW frames it
agrees with ``preprocess_frames_plain`` within 2.4e-7 at 480x960 -> 256x512
and -> 192x384.  ``chip_smoke.py`` times it as the library yardstick of the
preprocess kernel; the port does not call it.

``preprocess_frames`` runs ``ops/kernels.preprocess_resize``: on a card one
CUDA kernel (``csrc/preprocess.cu``) reads the uint8 frames once and writes
the resized float32 frames, from per-axis tap tables (``resize_taps``: each
output's 3-5 non-zero weights).  With the rig registration's per-image
shift and gain correction it folds those in too.  ``preprocess_frames_plain``
is the plain version, two dense matmuls:

    frames_u8 -> roll by (-dy, -dx) -> einsum(RH/255, x) -> einsum(RW, .)
              -> flip -> * gain

/255 is folded into the H matrix, and the flip comes after the resize:
flipping commutes with the symmetric resampling grid.  The roll is
``canonicalize.apply_shift_tc``, the multiply the pipeline's own.

With ``dtype="bfloat16"`` (a checkpoint's ``preprocess_dtype``) the result
is the JAX ``preprocess_frames(dtype=bfloat16)`` bit for bit: both matrices
rounded to bfloat16 (RH after the /255 is folded in), each einsum's float32
sums rounded to bfloat16 (the H pass before the W pass), the flip, then the
gain as the JAX pipelines apply it, ``bf16(x * bf16(gain))``.  The kernel
has a bfloat16-output instance that rounds at the same places.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from deepfly3d_torch.ops import canonicalize
from deepfly3d_torch.ops.bottleneck import round_bf16


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


@lru_cache(maxsize=16)
def resize_taps(n_in: int, n_out: int, scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of the resize as tap tables: (starts (n_out,) int32, weights (n_out, K) float32).

    Output ``o`` is ``sum_k weights[o, k] * x[starts[o] + k]``, summed in
    increasing ``k``.  The weights are the entries of ``_resize_matrix *
    float32(scale)`` (the same float32 product ``resize_matrices`` forms)
    from ``starts[o]`` on; ``K`` is the widest run of non-zero weights, and
    a row whose run ends near the last input starts earlier, with leading
    zeros, so every tap lies inside the axis.  Scattering the weights back
    rebuilds the matrix exactly.
    """
    m = _resize_matrix(n_in, n_out) * np.float32(scale)
    nonzero = m != 0
    any_nz = nonzero.any(axis=1)
    first = np.where(any_nz, nonzero.argmax(axis=1), 0)
    last = np.where(any_nz, n_in - 1 - nonzero[:, ::-1].argmax(axis=1), 0)
    k = int((last - first).max()) + 1
    starts = np.minimum(first, n_in - k).astype(np.int32)
    weights = np.take_along_axis(m, starts[:, None] + np.arange(k)[None, :], axis=1)
    weights = np.ascontiguousarray(weights, np.float32)
    starts.flags.writeable = False
    weights.flags.writeable = False
    return starts, weights


PREPROCESS_DTYPES = ("float32", "bfloat16")


def check_dtype(dtype: str) -> torch.dtype:
    """A ``preprocess_dtype`` name -> its torch dtype; ValueError for any other."""
    if str(dtype) not in PREPROCESS_DTYPES:
        raise ValueError(f"preprocess dtype {dtype!r}: the port computes {PREPROCESS_DTYPES}")
    return getattr(torch, str(dtype))


def roll_frames(frames_u8: torch.Tensor, shift) -> torch.Tensor:
    """(N, H, W, C) rolled by (-dy[n], -dx[n]) per image, ``shift`` = (dy, dx)
    or None: ``canonicalize.apply_shift_tc`` with the images as its cameras."""
    if shift is None:
        return frames_u8
    return canonicalize.apply_shift_tc(frames_u8[None], shift[0], shift[1])[0]


def times_gain(x: torch.Tensor, gain) -> torch.Tensor:
    """(N, h, w, C) times a per-image (N,) ``gain``, or as it is for None."""
    return x if gain is None else x * gain[:, None, None, None]


def preprocess_frames_plain(frames_u8: torch.Tensor, flip: torch.Tensor,
                            out_shape: Tuple[int, int], dtype: str = "float32",
                            shift=None, gain=None) -> torch.Tensor:
    """Plain version of ``preprocess_frames``: the roll, two dense float32
    matmuls, the flip and the gain; at bfloat16 with the roundings of the
    module docstring, and a bfloat16 result."""
    bf16 = check_dtype(dtype) == torch.bfloat16
    n, h_in, w_in, c = frames_u8.shape
    rh, rw = resize_matrices((h_in, w_in), tuple(out_shape), frames_u8.device,
                             scale=1.0 / 255.0)
    rnd = round_bf16 if bf16 else (lambda t: t)
    x = roll_frames(frames_u8, shift).float()
    x = rnd(torch.einsum("oh,nhwc->nowc", rnd(rh), x))     # H first: shrinks the tensor
    x = rnd(torch.einsum("ow,nhwc->nhoc", rnd(rw), x))
    x = torch.where(flip.reshape(n, 1, 1, 1), x.flip(2), x)
    if not bf16:
        return times_gain(x, gain)
    return (x if gain is None else x * round_bf16(gain)[:, None, None, None]).to(torch.bfloat16)


def preprocess_frames(frames_u8: torch.Tensor, flip: torch.Tensor,
                      out_shape: Tuple[int, int], dtype: str = "float32",
                      shift=None, gain=None) -> torch.Tensor:
    """(N, H, W, 3) uint8 + (N,) bool flip -> (N, h, w, 3) in ``dtype``.

    Equal, up to the order of the sums, to casting to float, /255,
    flipping where ``flip`` and resizing with jax.image.resize "bilinear".
    ``shift`` = (dy, dx), (N,) int32 each, and ``gain``, (N,) float32, are
    the rig registration's: the frames rolled by (-dy, -dx) first
    (``canonicalize.apply_shift_tc``), the result times ``gain``.
    ``dtype`` is the checkpoint's ``preprocess_dtype``, "float32" or
    "bfloat16" (module docstring); any other raises.  Runs
    ``kernels.preprocess_resize``: the CUDA kernel on a card,
    ``preprocess_frames_plain`` on the CPU.
    """
    from deepfly3d_torch.ops.kernels import preprocess_resize   # kernels imports this module

    return preprocess_resize(frames_u8, flip, tuple(out_shape), shift=shift, gain=gain,
                             dtype=dtype)
