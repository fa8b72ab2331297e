"""Level merge, heatmap decode and frame preprocess: plain versions and CUDA wrappers.

Counterpart of ``deepfly3d_tpu/ops/pallas/kernels.py``:

* ``upsample2x_add`` — nearest-2x upsample of the inner hourglass level
  added to the skip branch (``csrc/upsample_add.cu``);
* ``decode_heatmaps`` — per image and joint, the heatmap maximum and its
  first-index argmax as normalized (row, col) (``csrc/decode.cu``);
* ``preprocess_resize`` — uint8 -> float32 / 255 with a horizontal flip per
  image (``preprocess_u8_pallas``), fused with the antialiased bilinear
  resize that follows it on every path and with the rig registration's
  per-image integer roll and gain correction around it (``csrc/preprocess.cu``).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain PyTorch version on a CPU tensor.  It launches under
``torch.cuda.device(<the input's device>)``: a launch goes to the calling
thread's current device, and the libraries read its SM count and
shared-memory opt-in through ``cudaGetDevice``; on a second card that need
not be the input's device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepfly3d_torch.ops import _build
from deepfly3d_torch.ops import image as image_ops


def _check_cuda(name: str, t: torch.Tensor, device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}")


# ------------------------------------------------------- upsample 2x + add


def upsample2x_add_plain(inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) inner + (N, 2H, 2W, C) skip -> (N, 2H, 2W, C), in their
    dtype (bfloat16: each sum in float32, rounded once)."""
    n, h, w, c = inner.shape
    up = inner[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    if skip.dtype == torch.bfloat16:
        return (skip.float() + up.reshape(n, 2 * h, 2 * w, c).float()).to(torch.bfloat16)
    return skip + up.reshape(n, 2 * h, 2 * w, c)


_MERGE_DTYPES = {torch.float32: "df3d_upsample2x_add", torch.bfloat16: "df3d_upsample2x_add_bf16"}


def upsample2x_add(inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample of ``inner`` plus ``skip``, NHWC, float32 or bfloat16.

    Launches ``csrc/upsample_add.cu``'s instance of their dtype on CUDA
    tensors (counted in ``upsample2x_add.launches``, float32, and
    ``upsample2x_add.launches_bf16``) or raises; plain version on CPU tensors.
    """
    if inner.dim() != 4 or skip.dim() != 4:
        raise ValueError("inner and skip must be NHWC")
    n, h, w, c = inner.shape
    if tuple(skip.shape) != (n, 2 * h, 2 * w, c):
        raise ValueError(f"skip shape {tuple(skip.shape)} != {(n, 2 * h, 2 * w, c)}")
    if inner.dtype != skip.dtype or skip.dtype not in _MERGE_DTYPES:
        raise ValueError(f"inner and skip must share one of {list(_MERGE_DTYPES)}, got "
                         f"{inner.dtype} and {skip.dtype}")
    if inner.device.type == "cpu":
        return upsample2x_add_plain(inner, skip)
    if inner.device.type != "cuda":
        raise ValueError(f"upsample2x_add runs on cuda or cpu, not {inner.device}")
    _check_cuda("inner", inner, inner.device, skip.dtype)
    _check_cuda("skip", skip, inner.device, skip.dtype)
    out = torch.empty_like(skip)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("upsample_add"), _MERGE_DTYPES[skip.dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(inner.device):      # a launch goes to the current device
        rc = fn(inner.data_ptr(), skip.data_ptr(), out.data_ptr(), n, h, w, c,
                torch.cuda.current_stream(inner.device).cuda_stream)
    _build.check(rc, "upsample2x_add kernel")
    if skip.dtype == torch.float32:
        upsample2x_add.launches += 1
    else:
        upsample2x_add.launches_bf16 += 1
    return out


upsample2x_add.launches = 0
upsample2x_add.launches_bf16 = 0


# ------------------------------------------------------------ heatmap decode


def decode_heatmaps_plain(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, K) -> ((N, K, 2) normalized (row, col), (N, K, 1) max).

    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``.
    The divisions are IEEE float32 divisions, as in the kernel: on a card,
    PyTorch divides by a Python number as a product with its reciprocal,
    one ulp off on grids that are no power of two (48x96), so the divisors
    are tensors on the heatmaps' device (filled there, with no host copy).
    """
    n, h, w, k = heatmaps.shape
    flat = heatmaps.float().permute(0, 3, 1, 2).reshape(n, k, h * w)
    idx = torch.argmax(flat, dim=-1)
    conf = torch.amax(flat, dim=-1, keepdim=True)
    h_t, w_t = (torch.full((), float(v), device=heatmaps.device) for v in (h, w))
    row = torch.div(idx, w, rounding_mode="floor").float() / h_t
    col = (idx % w).float() / w_t
    return torch.stack([row, col], dim=-1), conf


# the decode kernel splits every image's cells over thread blocks: two per SM
# of an H100 (132 SMs) over the whole launch, at least 64 cells each
_DECODE_BLOCKS = 2 * 132
_DECODE_MIN_CELLS = 64


@lru_cache(maxsize=None)
def _decode_kernel():
    fn = _build.library("decode").df3d_decode_heatmaps
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_splits(n: int, cells: int) -> int:
    """Thread blocks per image of the decode kernel's first pass."""
    want = -(-_DECODE_BLOCKS // max(n, 1))
    return max(1, min(want, cells // _DECODE_MIN_CELLS))


def decode_heatmaps(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax decode of (N, H, W, K) float32 heatmaps, first index on ties.

    Launches ``csrc/decode.cu`` on a CUDA tensor (its two passes count as one
    launch in ``decode_heatmaps.launches``) or raises; plain version on a CPU
    tensor.
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
    dev = heatmaps.device
    pts = torch.empty((n, k, 2), device=dev, dtype=torch.float32)
    conf = torch.empty((n, k, 1), device=dev, dtype=torch.float32)
    if n == 0:
        return pts, conf
    splits = decode_splits(n, h * w)
    # the first pass's partial (value, index) pairs: values in the first half
    part = torch.empty((2, n, splits, k), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        rc = _decode_kernel()(heatmaps.data_ptr(), pts.data_ptr(), conf.data_ptr(),
                              part.data_ptr(), part.data_ptr() + part.numel() * 2, n, h, w, k,
                              splits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "decode kernel")
    decode_heatmaps.launches += 1
    return pts, conf


decode_heatmaps.launches = 0


# ---------------------------------------------------------------- preprocess

# csrc/preprocess.cu has two designs (its header; ``preprocess_instance``
# picks).  The band design (runtime taps, for the shapes and pointers the run
# design does not take): the most uint8 input rows one band of output rows may
# stage, double-buffered in shared memory beside the band's float32 H-pass
# rows; a block takes as many output rows per band as keep within it
PREPROCESS_STAGE_ROWS = 8
_MAX_SMEM = 227 * 1024
# The run design: thread blocks of 8 H-pass warps (each thread up to 3
# column words of a row: rows of at most 3072 bytes), 4 W-pass warps and a
# producer warp; a ring of about this many bytes of input rows per block (7
# slots of 3088 bytes); ``PREPROCESS_RING_ROWS``, when set, is the ring's
# depth in rows instead; ``PREPROCESS_H_SLOTS`` float32 H rows between the H
# and the W warps
PREPROCESS_RUN_H = 256
PREPROCESS_RUN_WORDS = 3
PREPROCESS_RING_BYTES = 24 * 1024
PREPROCESS_RING_ROWS = None
PREPROCESS_H_SLOTS = 4
PREPROCESS_OPEN = 3            # output rows an input row may feed, and rows a step adds
_SM_SMEM = 228 * 1024          # shared memory of one H100 SM
_BLOCK_RESERVED = 1024         # the runtime's reserve per thread block
_SMS = 132                     # SMs of an H100 SXM


def preprocess_u8_plain(frames_u8: torch.Tensor, flip: torch.Tensor, shift=None,
                        gain=None) -> torch.Tensor:
    """The TPU kernel's function: (N, H, W, C) uint8 -> float32 * (1/255), flipped where ``flip``.

    With ``shift`` = (dy, dx) and ``gain`` ((N,) each), the rig registration
    around it: the frames rolled by (-dy, -dx) first, the result times gain.
    """
    x = image_ops.roll_frames(frames_u8, shift).float()
    x = x * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    n = x.shape[0]
    return image_ops.times_gain(torch.where(flip.reshape(n, 1, 1, 1).bool(), x.flip(2), x), gain)


def _taps(n_in: int, n_out: int, scale: float, bf16: bool):
    """``resize_taps`` with the weights rounded to bfloat16 values where ``bf16``."""
    starts, weights = image_ops.resize_taps(n_in, n_out, scale)
    if bf16:
        weights = torch.from_numpy(weights.copy()).to(torch.bfloat16).float().numpy()
    return starts, weights


@lru_cache(maxsize=16)
def _device_taps(n_in: int, n_out: int, scale: float, device: torch.device,
                 bf16: bool = False):
    """The tap tables on ``device``; with ``bf16`` the weights rounded to
    bfloat16 values (kept float32: the kernel sums in float32)."""
    starts, weights = _taps(n_in, n_out, scale, bf16)
    return (torch.from_numpy(starts.copy()).to(device),
            torch.from_numpy(np.array(weights)).to(device))


@lru_cache(maxsize=16)
def preprocess_steps(h_in: int, h_out: int, bf16: bool = False):
    """The run design's H-pass step table, or None where the taps do not fit it.

    -> (ends (h_out + 1,) int32, steps (h_out, 3, 4) float32).  With ``e[o] =
    sh[o] + K - 1`` the last input row of output row ``o``, ``ends[0] = sh[0] +
    K - 2`` and ``ends[o + 1] = e[o]``; step ``o`` adds the input rows
    ``ends[o] + 1 .. ends[o + 1]`` and ``steps[o, r, j]`` is the weight of the
    r-th of them in output row ``o + j`` (0 where it lies outside its taps;
    the fourth entry is padding).  None unless every step adds at most 3 rows
    and every row feeds only outputs ``o .. o + 2`` of its step.
    """
    starts, weights = _taps(h_in, h_out, 1.0 / 255.0, bf16)
    k = weights.shape[1]
    last = starts.astype(np.int64) + k - 1
    ends = np.concatenate([[starts[0] + k - 2], last])
    wide = np.any(starts[PREPROCESS_OPEN:] <= last[:-PREPROCESS_OPEN])   # a 4th row open
    if np.diff(ends).max() > PREPROCESS_OPEN or wide:
        return None
    rows = ends[:-1, None] + 1 + np.arange(PREPROCESS_OPEN)[None, :]          # (h_out, r)
    added = rows <= ends[1:, None]
    steps = np.zeros((h_out, PREPROCESS_OPEN, 4), np.float32)
    for j in range(PREPROCESS_OPEN):
        out_row = np.arange(h_out) + j
        ok = out_row < h_out
        tap = rows - starts[np.minimum(out_row, h_out - 1)][:, None]
        inside = added & ok[:, None] & (tap >= 0) & (tap < k)
        steps[:, :, j] = np.where(inside, weights[np.minimum(out_row, h_out - 1)[:, None],
                                                  np.clip(tap, 0, k - 1)], 0.0)
    ends = ends.astype(np.int32)
    ends.flags.writeable = False
    steps.flags.writeable = False
    return ends, steps


@lru_cache(maxsize=16)
def _device_steps(h_in: int, h_out: int, device: torch.device, bf16: bool = False):
    found = preprocess_steps(h_in, h_out, bf16)
    if found is None:
        return None
    return tuple(torch.from_numpy(np.array(t)).to(device) for t in found)


def preprocess_smem(w_in: int, c: int, h_out: int, w_out: int, kh: int, kw: int,
                    rows: int, stage_rows: int) -> int:
    """Shared memory of one thread block of the band design, in bytes
    (``df3d_preprocess_smem``): the four tap tables, ``rows`` float32 H-pass
    rows with a wrap margin of ``kw - 1`` pixels, two buffers of
    ``stage_rows`` uint8 input rows."""
    r4 = lambda v: -(-v // 4) * 4
    band_pitch = w_in * c + r4(c * (kw - 1))
    stage_pitch = -(-(w_in * c) // 16) * 16
    return 4 * (r4(h_out * kh) + r4(w_out * kw) + r4(h_out) + r4(w_out) + rows * band_pitch) \
        + 2 * stage_rows * stage_pitch


@lru_cache(maxsize=64)
def preprocess_plan(h_in: int, w_in: int, c: int, h_out: int, w_out: int,
                    max_stage_rows: int) -> Tuple[int, int, int]:
    """-> (rows, stage_rows, shared memory bytes) of one launch of the band design.

    ``rows``, the output rows per band, is the most whose input rows
    (``stage_rows``, the most one band reads) stay within ``max_stage_rows``
    and whose thread block fits in 227 KB of shared memory; at least one.
    Raises when the input rows of one output row do not fit (at 960x3, more
    than ~35 H taps: a downscale by more than ~17).
    """
    starts, wh = image_ops.resize_taps(h_in, h_out, 1.0 / 255.0)
    kh, kw = wh.shape[1], image_ops.resize_taps(w_in, w_out, 1.0)[1].shape[1]
    for r in range(min(h_out, max_stage_rows), 0, -1):
        o0 = np.arange(0, h_out, r)
        o_last = np.minimum(o0 + r, h_out) - 1
        stage_rows = int((starts[o_last] + kh - starts[o0]).max())
        smem = preprocess_smem(w_in, c, h_out, w_out, kh, kw, r, stage_rows)
        if (stage_rows <= max_stage_rows or r == 1) and smem <= _MAX_SMEM:
            return r, stage_rows, smem
    raise ValueError(f"the {kh} input rows of {w_in}x{c} that one output row reads exceed one "
                     f"thread block's shared memory")


def _run_slot_pitch(row_len: int) -> int:
    """Bytes of one ring slot: a row's 16-byte cover, and every H thread's
    words, which it reads past a shorter row."""
    read = 4 * PREPROCESS_RUN_WORDS * PREPROCESS_RUN_H
    return -(-(max(row_len, read) + 12) // 16) * 16


def preprocess_run_smem(w_in: int, c: int, w_out: int, kw: int, ring_rows: int,
                        hslots: int) -> int:
    """Shared memory of one thread block of the run design, in bytes
    (``df3d_preprocess_run_smem``): a full and an empty mbarrier per ring
    slot and per H-row slot, the W tap tables, ``hslots`` float32 H rows
    with a wrap margin of ``kw - 1`` pixels, ``ring_rows`` slots of a row's
    16-byte cover (the row and up to 12 bytes before it)."""
    r4 = lambda v: -(-v // 4) * 4
    hpitch = w_in * c + r4(c * (kw - 1))
    return 16 * (ring_rows + hslots) + 4 * (r4(w_out * kw) + r4(w_out) + hslots * hpitch) \
        + ring_rows * _run_slot_pitch(w_in * c)


class RunPlan(NamedTuple):
    ring_rows: int      # input-row slots of one thread block
    hslots: int         # H-row slots between its H and W warps
    per_sm: int         # thread blocks per SM
    smem: int           # shared memory of one thread block, bytes
    grid: int           # thread blocks of a launch on ``sms`` SMs


@lru_cache(maxsize=64)
def preprocess_run_plan(n: int, h_in: int, w_in: int, c: int, h_out: int, w_out: int,
                        ring_rows: Optional[int] = None, sms: int = _SMS) -> RunPlan:
    """The run design's launch for a shape: ring depth, H-row slots, thread
    blocks per SM and the grid (the kernel caps the blocks per SM at what
    fits).  The ring holds ``ring_rows`` rows, or about
    ``PREPROCESS_RING_BYTES``, and never fewer than the input rows of one
    output row (its H taps), so that a whole output row's rows can be in
    flight.
    """
    kh = image_ops.resize_taps(h_in, h_out, 1.0 / 255.0)[1].shape[1]
    kw = image_ops.resize_taps(w_in, w_out, 1.0)[1].shape[1]
    slot_pitch = _run_slot_pitch(w_in * c)
    ring = ring_rows or min(16, PREPROCESS_RING_BYTES // slot_pitch)
    ring = max(int(ring), kh)
    hslots = PREPROCESS_H_SLOTS
    smem = preprocess_run_smem(w_in, c, w_out, kw, ring, hslots)
    per_sm = 2 if 2 * (smem + _BLOCK_RESERVED) <= _SM_SMEM else 1
    if smem > _MAX_SMEM:
        raise ValueError(f"the run design's thread block needs {smem} bytes of shared memory")
    return RunPlan(ring, hslots, per_sm, smem, max(1, min(per_sm * sms, n * h_out)))


def preprocess_runs(n: int, h_out: int, grid: int):
    """The runs each thread block of the run design walks, as the kernel
    splits them: the N * h_out output rows, flattened, evenly over ``grid``
    blocks, each block's share cut at image boundaries.  -> per block, a list
    of (image, first output row, end output row)."""
    total = n * h_out
    blocks = []
    for b in range(grid):
        g, g1 = total * b // grid, total * (b + 1) // grid
        runs = []
        while g < g1:
            img, oa = divmod(g, h_out)
            ob = min(h_out, oa + (g1 - g))
            runs.append((img, oa, ob))
            g += ob - oa
        blocks.append(runs)
    return blocks


def preprocess_instance(c: int, w_in: int, w_out: int, kh: int, kw: int, steps: bool,
                        src_ptr: int, out_ptr: int) -> int:
    """The instance ``csrc/preprocess.cu`` runs for a call (its ``instance()``):
    256 + K * 16 + K for the run design's compile-time taps, 0 for the band
    design's runtime taps.  ``steps``: the H taps have a step table
    (``preprocess_steps``)."""
    row_len = w_in * c
    if (kh == kw and kh in (1, 4, 5, 6) and steps and c == 3 and row_len % 4 == 0
            and row_len <= 4 * PREPROCESS_RUN_WORDS * PREPROCESS_RUN_H
            and w_out % 4 == 0 and src_ptr % 4 == 0 and out_ptr % 16 == 0):
        return 256 + kh * 16 + kw
    return 0


def preprocess_instance_name(code: int) -> str:
    """A ``preprocess_instance`` code in words: "run 6x6" or "runtime taps"."""
    return f"run {(code - 256) // 16}x{(code - 256) % 16}" if code else "runtime taps"


def preprocess_instance_for(frames_u8: torch.Tensor, out: torch.Tensor) -> str:
    """The instance ``preprocess_resize`` runs to fill ``out`` from these
    frames, in words (``preprocess_instance_name``): on a card asked of the
    library (``df3d_preprocess_instance``), on the CPU its mirror."""
    _, h_in, w_in, c = frames_u8.shape
    h_out, w_out = out.shape[1:3]
    args = (c, w_in, w_out, image_ops.resize_taps(h_in, h_out)[1].shape[1],
            image_ops.resize_taps(w_in, w_out)[1].shape[1],
            preprocess_steps(h_in, h_out) is not None, frames_u8.data_ptr(), out.data_ptr())
    if frames_u8.device.type != "cuda":
        return preprocess_instance_name(preprocess_instance(*args))
    fn = _build.library("preprocess").df3d_preprocess_instance
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return preprocess_instance_name(fn(*args))


def _check_per_image(name: str, t, n: int, dtype: torch.dtype, device: torch.device) -> None:
    if (not isinstance(t, torch.Tensor) or tuple(t.shape) != (n,) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({n},) {dtype} tensor on {device}")


def preprocess_resize(frames_u8: torch.Tensor, flip: torch.Tensor, out_shape: Tuple[int, int],
                      shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      gain: Optional[torch.Tensor] = None, dtype: str = "float32") -> torch.Tensor:
    """(N, H, W, C) uint8 + (N,) bool flip -> (N, h, w, C) in ``dtype``.

    ``/255``, the flip and the antialiased bilinear resize to ``out_shape``
    in one pass, and with ``shift`` = (dy, dx), (N,) int32 each, and
    ``gain``, (N,) float32, the rig registration around it: bit for bit the
    resize of ``canonicalize.apply_shift_tc``'s frames (rolled by (-dy, -dx))
    times ``gain``.  At ``out_shape == (H, W)`` the taps are the identity and
    this is exactly ``preprocess_u8_plain``.  ``dtype="bfloat16"``: the
    bfloat16 result of ``image.preprocess_frames`` (its roundings).
    Launches ``csrc/preprocess.cu``'s instance of ``dtype`` on CUDA tensors
    (counted in ``preprocess_resize.launches``, float32, and
    ``preprocess_resize.launches_bf16``) or raises;
    ``image.preprocess_frames_plain`` on CPU tensors.  Reads nothing back
    from the card.
    """
    bf16 = image_ops.check_dtype(dtype) == torch.bfloat16
    if frames_u8.dim() != 4 or frames_u8.dtype != torch.uint8:
        raise ValueError("frames_u8 must be an (N, H, W, C) uint8 tensor")
    n, h_in, w_in, c = frames_u8.shape
    h_out, w_out = (int(v) for v in out_shape)
    dev = frames_u8.device
    if tuple(flip.shape) != (n,) or flip.dtype != torch.bool:
        raise ValueError(f"flip must be an ({n},) bool tensor")
    if h_in < 1 or w_in < 1 or h_out < 1 or w_out < 1:
        raise ValueError(f"empty frames or output shape: {tuple(frames_u8.shape)} -> {out_shape}")
    if shift is not None:
        if not isinstance(shift, (tuple, list)) or len(shift) != 2:
            raise ValueError("shift must be a pair (dy, dx)")
        for name, t in zip(("dy", "dx"), shift):
            _check_per_image(name, t, n, torch.int32, dev)
    if gain is not None:
        _check_per_image("gain", gain, n, torch.float32, dev)
    if dev.type == "cpu":
        return image_ops.preprocess_frames_plain(frames_u8, flip, (h_out, w_out), dtype,
                                                 shift=shift, gain=gain)
    if dev.type != "cuda":
        raise ValueError(f"preprocess_resize runs on cuda or cpu, not {dev}")
    if not frames_u8.is_contiguous() or flip.device != dev or not flip.is_contiguous():
        raise ValueError(f"frames_u8 and flip must be contiguous tensors on {dev}")
    sh, wh = _device_taps(h_in, h_out, 1.0 / 255.0, dev, bf16)
    sw, ww = _device_taps(w_in, w_out, 1.0, dev, bf16)
    steps = _device_steps(h_in, h_out, dev, bf16)
    out = torch.empty((n, h_out, w_out, c), device=dev,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    if n == 0:
        return out
    kh, kw = wh.shape[1], ww.shape[1]
    rows = stage_rows = ring_rows = hslots = per_sm = 1  # the other design's plan: unused
    if preprocess_instance(c, w_in, w_out, kh, kw, steps is not None, frames_u8.data_ptr(),
                           out.data_ptr()) >= 256:
        ring_rows, hslots, per_sm = preprocess_run_plan(n, h_in, w_in, c, h_out, w_out,
                                                        PREPROCESS_RING_ROWS)[:3]
    else:
        rows, stage_rows, _ = preprocess_plan(h_in, w_in, c, h_out, w_out,
                                              PREPROCESS_STAGE_ROWS)
    ends, table = (0, 0) if steps is None else (steps[0].data_ptr(), steps[1].data_ptr())
    dy, dx = (0, 0) if shift is None else (shift[0].data_ptr(), shift[1].data_ptr())
    lib = _build.library("preprocess")
    fn = lib.df3d_preprocess_resize_bf16 if bf16 else lib.df3d_preprocess_resize
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):          # the library asks cudaGetDevice for the SM count
        rc = fn(frames_u8.data_ptr(), flip.data_ptr(), dy, dx,
                0 if gain is None else gain.data_ptr(), sh.data_ptr(), wh.data_ptr(),
                sw.data_ptr(), ww.data_ptr(), ends, table, out.data_ptr(), n, h_in, w_in, c,
                h_out, w_out, kh, kw, rows, stage_rows, ring_rows, hslots, per_sm,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "preprocess kernel")
    if bf16:
        preprocess_resize.launches_bf16 += 1
    else:
        preprocess_resize.launches += 1
    return out


preprocess_resize.launches = 0
preprocess_resize.launches_bf16 = 0
