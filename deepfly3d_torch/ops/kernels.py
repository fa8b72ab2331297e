"""Level merge, heatmap decode, frame preprocess, conv stem and stack heads:
plain versions and CUDA wrappers.

Counterpart of ``deepfly3d_tpu/ops/pallas/kernels.py``:

* ``upsample2x_add`` — nearest-2x upsample of the inner hourglass level
  added to the skip branch (``csrc/upsample_add.cu``);
* ``decode_heatmaps`` — per image and joint, the heatmap maximum and its
  first-index argmax as normalized (row, col) (``csrc/decode.cu``);
* ``preprocess_resize`` — uint8 -> float32 / 255 with a horizontal flip per
  image (``preprocess_u8_pallas``), fused with the antialiased bilinear
  resize that follows it on every path and with the rig registration's
  per-image integer roll and gain correction around it (``csrc/preprocess.cu``);
* ``stem_conv`` — the hourglass's conv stem, relu(conv7x7/2(x) + b), in one
  pass (``csrc/stem_conv.cu``; no TPU kernel: the JAX package leaves the stem
  to XLA);
* ``stack_heads`` — one stack's 1x1 head chain (feature head and its ReLU,
  score head, and between stacks both remaps and the two adds of the
  re-injection) in one pass (``csrc/stack_heads.cu``; no TPU kernel either).

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
from deepfly3d_torch.ops import bottleneck as bn_ops
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
_MERGE_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


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
    fn = _build.entry("upsample_add", _MERGE_DTYPES[skip.dtype], _MERGE_ARGS)
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


# ------------------------------------------------------------------ conv stem

# csrc/stem_conv.cu: K is 7 kernel rows of 24 values (a zero weight, the row's
# 7 columns x 3 channels, two zero weights), 21 k steps of 8, each as the TF32
# hi and then the lo half of the weights in wgmma's K-major core matrices; its
# instances, every conv stem's Cout the port ships
STEM_WIDTHS = (8, 32, 48, 64, 128)
_STEM_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
STEM_ROW_K = 24
STEM_K = 7 * STEM_ROW_K


def conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, b: torch.Tensor,
              stride: int, padding: int) -> torch.Tensor:
    """A zero-padded convolution of an NHWC tensor with OIHW weights, plus ``b``."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride,
                                   padding=padding)
    return y.permute(0, 2, 3, 1) + b


def pack_stem(w_oihw: torch.Tensor) -> torch.Tensor:
    """(Cout, 3, 7, 7) float32 weights -> the stem kernel's flat float32 buffer:
    K = ``STEM_K`` rows (kernel row ky's value 1 + 3 kx + c is channel c of
    column kx; the rest zero), Cout padded to a multiple of 8 with zeros, as
    ``bottleneck._pack_tf32``'s "pair" order in one pass over the columns (hi,
    then lo = w - hi, so that hi + lo == w bit for bit)."""
    cout = w_oihw.shape[0]
    if tuple(w_oihw.shape) != (cout, 3, 7, 7):
        raise ValueError(f"the conv stem's weights must be (Cout, 3, 7, 7), got "
                         f"{tuple(w_oihw.shape)}")
    coutp = -(-cout // 8) * 8
    wk = np.zeros((7, STEM_ROW_K, coutp), np.float32)
    hwio = w_oihw.detach().cpu().float().permute(2, 3, 1, 0).numpy()     # (ky, kx, c, o)
    wk[:, 1:22, :cout] = hwio.reshape(7, 21, cout)
    return torch.from_numpy(bn_ops._pack_tf32(wk.reshape(STEM_K, coutp), "pair", coutp))


def _unpack_tf32(flat: torch.Tensor, rows: int, cols: int, order: str) -> torch.Tensor:
    """One weight of ``bottleneck._pack_tf32``'s layout in one pass of ``cols``
    columns -> (rows, cols), hi + lo, bit for bit: row 8 s + 2 j + kc of k half
    kc, element j of step s ("pair"), or 16 (s // 2) + 4 j + 2 (s % 2) + kc
    ("quad")."""
    # (step, hi|lo, column group, k half, column, element)
    parts = flat.reshape(rows // 8, 2, cols // 8, 2, 8, 4)
    w = parts[:, 0] + parts[:, 1]
    if order == "pair":                     # -> (step, element, k half, group, column)
        return w.permute(0, 4, 2, 1, 3).reshape(rows, cols)
    # (step pair, step parity, ...) -> (step pair, element, parity, k half, group, column)
    w = w.reshape(rows // 16, 2, cols // 8, 2, 8, 4).permute(0, 5, 1, 3, 2, 4)
    return w.reshape(rows, cols)


def unpack_stem(w_packed: torch.Tensor, cout: int) -> torch.Tensor:
    """``pack_stem``'s buffer -> the (Cout, 3, 7, 7) weights, bit for bit, on
    the buffer's device."""
    coutp = -(-cout // 8) * 8
    if w_packed.numel() != 2 * STEM_K * coutp:
        raise ValueError(f"w_packed has {w_packed.numel()} values: not a stem of Cout {cout}")
    wk = _unpack_tf32(w_packed, STEM_K, coutp, "pair")
    hwio = wk.reshape(7, STEM_ROW_K, coutp)[:, 1:22, :cout].reshape(7, 7, 3, cout)
    return hwio.permute(3, 2, 0, 1).contiguous()


def stem_conv_plain(x: torch.Tensor, w_packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv7x7 of stride 2, zero padding 3, + b): (N, H, W, 3) float32 ->
    (N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, Cout), the weights unpacked from
    ``pack_stem``'s buffer."""
    return torch.relu(conv_nhwc(x, unpack_stem(w_packed, b.shape[0]), b, 2, 3))


def stem_conv(x: torch.Tensor, w_packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conv stem, ``stem_conv_plain``'s function, in one pass.

    Launches ``csrc/stem_conv.cu``'s instance of Cout on CUDA tensors
    (counted in ``stem_conv.launches``) or raises: a Cout outside
    ``STEM_WIDTHS``, a tensor that is not contiguous float32 on x's device;
    ``stem_conv_plain`` on CPU tensors.  Rows of any width run.
    """
    if x.dim() != 4 or x.shape[3] != 3 or b.dim() != 1:
        raise ValueError(f"x must be (N, H, W, 3) and b (Cout,), got {tuple(x.shape)} and "
                         f"{tuple(b.shape)}")
    if w_packed.device != x.device or b.device != x.device:
        raise ValueError(f"x, w_packed and b must be on one device, got {x.device}, "
                         f"{w_packed.device} and {b.device}")
    if x.device.type == "cpu":
        return stem_conv_plain(x, w_packed, b)
    n, h, w, _ = x.shape
    cout = b.shape[0]
    if cout not in STEM_WIDTHS:
        raise ValueError(f"the stem kernel takes Cout in {STEM_WIDTHS}, not {cout}")
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv runs on cuda or cpu, not {x.device}")
    for name, t, align in (("x", x, 4), ("w_packed", w_packed, 16), ("b", b, 8)):
        _check_cuda(name, t, x.device)
        if t.data_ptr() % align:            # a bulk copy of the weights, 8-byte bias loads
            raise ValueError(f"{name} must be {align}-byte aligned")
    if w_packed.numel() != 2 * STEM_K * cout:
        raise ValueError(f"w_packed has {w_packed.numel()} values: not a stem of Cout {cout}")
    y = torch.empty((n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, cout), device=x.device)
    if y.numel() == 0:
        return y
    fn = _build.entry("stem_conv", "df3d_stem_conv", _STEM_ARGS)
    with torch.cuda.device(x.device):      # the library asks cudaGetDevice for the SM count
        rc = fn(x.data_ptr(), w_packed.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, w, cout,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "stem kernel")
    stem_conv.launches += 1
    return y


stem_conv.launches = 0


# --------------------------------------------------------------- stack heads

# csrc/stack_heads.cu: the feature widths of its instance, and the score head's
# columns as it runs them (the classes padded with zero weights)
HEAD_WIDTHS = (96,)
HEAD_CLASSES = 24
_HEADS_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_HEAD_BIASES = ("feat_b", "score_b", "remap_feat_b", "remap_score_b")


def dot1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution of an NHWC tensor: x @ w + b."""
    return x @ w + b


def _head_layout(f: int, remap: bool):
    """[((weight, rows, columns) side by side, k order)] of ``pack_heads``'
    buffer for F = ``f``, the classes padded to ``HEAD_CLASSES``: feat_w; the
    score head, with remap_feat_w beside it where ``remap``; remap_score_w."""
    k = HEAD_CLASSES
    score = (("score_w", f, k), ("remap_feat_w", f, f)) if remap else (("score_w", f, k),)
    parts = [((("feat_w", f, f),), "quad"), (score, "pair")]
    return parts + [((("remap_score_w", k, f),), "pair")] if remap else parts


def _head_sizes(f: int, remap: bool) -> Tuple[int, int]:
    """(packed, biases) values of ``pack_heads``' buffers."""
    packed = sum(2 * ws[0][1] * sum(c for *_, c in ws) for ws, _ in _head_layout(f, remap))
    return packed, f + HEAD_CLASSES + (2 * f if remap else 0)


def _check_head_buffers(packed: torch.Tensor, biases: torch.Tensor, f: int, remap: bool) -> None:
    if (packed.numel(), biases.numel()) != _head_sizes(f, remap):
        raise ValueError(f"packed ({packed.numel()}) and biases ({biases.numel()}) are not the "
                         f"heads of F={f}" + (" with the remaps" if remap else ""))


def pack_heads(stack) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stack's folded float32 1x1 heads (``feat_w`` (F, F), ``score_w`` (F, K)
    and, between stacks, ``remap_feat_w`` (F, F) and ``remap_score_w`` (K, F),
    with their biases) -> the head kernel's (packed weights, biases), float32
    on the CPU.

    The weights as ``bottleneck._pack_tf32`` lays them out, each part in one
    pass of all its columns: ``feat_w`` in the "quad" k order (a lane reads 16
    bytes of a pixel for two k steps); in the "pair" order (A an accumulator
    fragment) the score head with K padded to ``HEAD_CLASSES`` with zero
    weights and, between stacks, ``remap_feat_w`` beside it as one (F, 24 + F)
    weight, then ``remap_score_w`` with its rows padded.  The biases are one
    vector: feat_b, score_b padded with zeros, remap_feat_b, remap_score_b.
    ``unpack_heads`` inverts both bit for bit.
    """
    k = stack["score_w"].shape[1]
    if k > HEAD_CLASSES:
        raise ValueError(f"the head kernel takes at most {HEAD_CLASSES} classes, not {k}")
    remap = "remap_feat_w" in stack
    weights = []
    for side, order in _head_layout(stack["feat_w"].shape[0], remap):
        blocks = []
        for name, rows, cols in side:
            block = np.zeros((rows, cols), np.float32)
            src = stack[name].detach().cpu().float().numpy()
            block[:src.shape[0], :src.shape[1]] = src
            blocks.append(block)
        w = np.concatenate(blocks, axis=1)
        weights.append(bn_ops._pack_tf32(w, order, w.shape[1]))
    biases = []
    for name in _HEAD_BIASES[:4 if remap else 2]:
        b = stack[name].detach().cpu().float().numpy()
        biases.append(np.pad(b, (0, HEAD_CLASSES - b.shape[0])) if name == "score_b" else b)
    return (torch.from_numpy(np.concatenate(weights)),
            torch.from_numpy(np.concatenate(biases).astype(np.float32)))


def unpack_heads(packed: torch.Tensor, biases: torch.Tensor, features: int, classes: int,
                 remap: bool):
    """``pack_heads``' buffers -> {name: weight or bias} at the unpadded
    widths, contiguous, bit for bit, on the buffers' device."""
    _check_head_buffers(packed, biases, features, remap)
    out, at = {}, 0
    for side, order in _head_layout(features, remap):
        rows, cols = side[0][1], sum(c for *_, c in side)
        w = _unpack_tf32(packed[at:at + 2 * rows * cols], rows, cols, order)
        col = 0
        for name, r, c in side:
            part = w[:, col:col + c]
            out[name] = {"score_w": part[:, :classes], "remap_score_w": part[:classes]}.get(
                name, part).contiguous()
            col += c
        at += 2 * rows * cols
    widths = (features, HEAD_CLASSES, features, features)
    bat = 0
    for name, c in zip(_HEAD_BIASES[:4 if remap else 2], widths):
        out[name] = biases[bat:bat + (classes if name == "score_b" else c)]
        bat += c
    return out


def stack_heads_plain(f_in: torch.Tensor, y: Optional[torch.Tensor], packed: torch.Tensor,
                      biases: torch.Tensor, out: torch.Tensor) -> Optional[torch.Tensor]:
    """One stack's float32 1x1 head chain on NHWC tensors, the weights
    unpacked from ``pack_heads``' buffers: ``raw = relu(f_in @ feat_w + b) @
    score_w + b`` into ``out`` (N, H, W, K); with ``y`` (every stack but the
    last), returns ``(y + remap(f)) + remap(raw)``, else None."""
    w = unpack_heads(packed, biases, f_in.shape[-1], out.shape[-1], y is not None)
    f = torch.relu(dot1x1(f_in, w["feat_w"], w["feat_b"]))
    raw = dot1x1(f, w["score_w"], w["score_b"])
    out.copy_(raw)
    if y is None:
        return None
    rf = dot1x1(f, w["remap_feat_w"], w["remap_feat_b"])
    rs = dot1x1(raw, w["remap_score_w"], w["remap_score_b"])
    return (y + rf) + rs


def stack_heads(f_in: torch.Tensor, y: Optional[torch.Tensor], packed: torch.Tensor,
                biases: torch.Tensor, out: torch.Tensor) -> Optional[torch.Tensor]:
    """One stack's head chain, ``stack_heads_plain``'s function, in one pass:
    writes the score head's output into ``out`` and returns the next stack's
    input (None for the last stack, ``y`` None).

    Launches ``csrc/stack_heads.cu`` on CUDA tensors (counted in
    ``stack_heads.launches``) or raises: F outside ``HEAD_WIDTHS``, more than
    ``HEAD_CLASSES`` classes, a tensor that is not contiguous float32 on
    f_in's device; ``stack_heads_plain`` on CPU tensors.
    """
    if f_in.dim() != 4 or out.dim() != 4 or tuple(out.shape[:3]) != tuple(f_in.shape[:3]):
        raise ValueError(f"f_in must be (N, H, W, F) and out (N, H, W, K), got "
                         f"{tuple(f_in.shape)} and {tuple(out.shape)}")
    if y is not None and y.shape != f_in.shape:
        raise ValueError(f"y {tuple(y.shape)} must have f_in's shape {tuple(f_in.shape)}")
    dev = f_in.device
    for t in (y, packed, biases, out):
        if t is not None and t.device != dev:
            raise ValueError(f"f_in, y, packed, biases and out must be on one device, got "
                             f"{t.device} beside {dev}")
    if dev.type == "cpu":
        return stack_heads_plain(f_in, y, packed, biases, out)
    n, h, w, f = f_in.shape
    k = out.shape[3]
    if f not in HEAD_WIDTHS:
        raise ValueError(f"the head kernel takes F in {HEAD_WIDTHS}, not {f}")
    if not 1 <= k <= HEAD_CLASSES:
        raise ValueError(f"the head kernel takes 1 to {HEAD_CLASSES} classes, not {k}")
    if dev.type != "cuda":
        raise ValueError(f"stack_heads runs on cuda or cpu, not {dev}")
    y_out = None if y is None else torch.empty_like(f_in)
    for name, t, align in (("f_in", f_in, 16), ("y", y, 16), ("packed", packed, 16),
                           ("biases", biases, 8), ("out", out, 4), ("y_out", y_out, 8)):
        if t is None:
            continue
        _check_cuda(name, t, dev)
        if t.data_ptr() % align:            # 16-byte loads of f_in and y; the weights' bulk copy
            raise ValueError(f"{name} must be {align}-byte aligned")
    _check_head_buffers(packed, biases, f, y is not None)
    if n * h * w == 0:
        return y_out
    if n * h * w > 2 ** 31 - 65:             # the kernel counts pixels in an int
        raise ValueError(f"the head kernel takes at most 2**31 - 65 pixels, not {n * h * w}")
    fn = _build.entry("stack_heads", "df3d_stack_heads", _HEADS_ARGS)
    with torch.cuda.device(dev):           # the library asks cudaGetDevice for the SM count
        rc = fn(f_in.data_ptr(), 0 if y is None else y.data_ptr(), packed.data_ptr(),
                biases.data_ptr(), out.data_ptr(), 0 if y_out is None else y_out.data_ptr(),
                n * h * w, f, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "stack heads kernel")
    stack_heads.launches += 1
    return y_out


stack_heads.launches = 0


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
# over the whole launch, at least 64 cells each
_DECODE_BLOCKS = 2 * bn_ops.NUM_SMS
_DECODE_MIN_CELLS = 64
_DECODE_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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
    fn = _build.entry("decode", "df3d_decode_heatmaps", _DECODE_ARGS)
    with torch.cuda.device(dev):
        rc = fn(heatmaps.data_ptr(), pts.data_ptr(), conf.data_ptr(), part.data_ptr(),
                part.data_ptr() + part.numel() * 2, n, h, w, k, splits,
                torch.cuda.current_stream(dev).cuda_stream)
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
# the C entries' arguments: df3d_preprocess_resize(_bf16), df3d_preprocess_instance
_PREPROCESS_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 13 + (ctypes.c_void_p,)
_INSTANCE_ARGS = (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 2


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
        if (stage_rows <= max_stage_rows or r == 1) and smem <= bn_ops.MAX_SMEM:
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
                        ring_rows: Optional[int] = None, sms: int = bn_ops.NUM_SMS) -> RunPlan:
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
    if smem > bn_ops.MAX_SMEM:
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
    fn = _build.entry("preprocess", "df3d_preprocess_instance", _INSTANCE_ARGS)
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
    fn = _build.entry("preprocess", "df3d_preprocess_resize" + ("_bf16" if bf16 else ""),
                      _PREPROCESS_ARGS)
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
