"""The benchmark's own arithmetic: operations and bytes of the 2D->3D call.

A frozen copy of the counts in ``deepfly3d_torch/bench.py`` (``block_flops``,
``forward_flops``, ``preprocess_flops``), so that no change to the program
can move the yardstick, with the stem's widths taken from the configuration
(``stem_channels``) and not derived from ``features``, plus what that module
does not count: the list of residual blocks one forward launches, each
block's bytes, and the roofline bound of a block or of the preprocess.  Every count is of the model's work
(2 FLOPs per multiply-add), never of an implementation's passes: a float32
product computed as three TF32 products counts once.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32 = 4


@lru_cache(maxsize=1)
def peaks() -> dict:
    """The card's published peaks (``peaks.json``)."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def peak_flops(dtype: str) -> float:
    """The dense tensor-core rate at which the card multiplies ``dtype``
    operands at all: TF32's for float32, bf16's for bfloat16."""
    return float(peaks()["flops"][dtype])


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def block_macs(cin: int, cout: int) -> int:
    """Multiply-adds per pixel of one bottleneck: 1x1 cin->mid, 3x3
    mid->mid, 1x1 mid->cout and, where the widths differ, the 1x1
    projection cin->cout (mid = cout // 2)."""
    mid = cout // 2
    return cin * mid + 9 * mid * mid + mid * cout + (cin * cout if cin != cout else 0)


def block_flops(h: int, w: int, cin: int, cout: int) -> int:
    return 2 * h * w * block_macs(cin, cout)


class Block(NamedTuple):
    """One residual block of a forward, per image: its map and widths."""

    h: int
    w: int
    cin: int
    cout: int


def trunk_shape(spec: dict, input_shape: Tuple[int, int]) -> Tuple[int, int]:
    """The (h, w) at which the hourglasses run (the conv stem's /4)."""
    h, w = input_shape
    if spec["stem"] != "conv":
        raise ValueError(f"stem {spec['stem']!r}: the yardstick counts the conv stem only")
    return _conv_out(h, 7, 2, 3) // 2, _conv_out(w, 7, 2, 3) // 2


def blocks(spec: dict, input_shape: Tuple[int, int]) -> List[Block]:
    """Every residual block one image's forward runs, in launch order: the
    stem's three, Residual(c0, c1) before its pool, Residual(c1, c2) and
    Residual(c2, features) after it (``stem_channels`` = c0, c1, c2), then
    the hourglasses'."""
    f, nb = spec["features"], spec["num_blocks"]
    c0, c1, c2 = spec["stem_channels"]
    h, w = input_shape
    h2, w2 = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    th, tw = trunk_shape(spec, input_shape)
    out = [Block(h2, w2, c0, c1), Block(th, tw, c1, c2), Block(th, tw, c2, f)]

    def level(hh, ww, d):
        out.extend([Block(hh, ww, f, f)] * nb)                    # skip
        out.extend([Block(hh // 2, ww // 2, f, f)] * nb)          # down
        if d > 1:
            level(hh // 2, ww // 2, d - 1)
        else:
            out.extend([Block(hh // 2, ww // 2, f, f)] * nb)      # innermost
        out.extend([Block(hh // 2, ww // 2, f, f)] * nb)          # up

    for _ in range(spec["num_stacks"]):
        level(th, tw, spec["depth"])
        out.append(Block(th, tw, f, f))                           # feat_res
    return out


def block_bytes(b: Block, n: int) -> int:
    """x read once, the weights and vectors once, the output written once."""
    mid = b.cout // 2
    weights = b.cin * mid + 9 * mid * mid + mid * b.cout + (b.cin * b.cout if b.cin != b.cout else 0)
    vectors = 2 * b.cin + 2 * mid + b.cout + (b.cout if b.cin != b.cout else 0)
    return F32 * (n * b.h * b.w * (b.cin + b.cout) + weights + vectors)


def bound_s(ops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The roofline bound: -> (seconds, "ops" or "bytes", whichever sets it)."""
    t_ops = ops / peak_flops(dtype)
    t_bytes = nbytes / float(peaks()["hbm_bytes_per_s"])
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def forward_flops(spec: dict, n: int, input_shape: Tuple[int, int]) -> Dict[str, int]:
    """FLOPs of one folded forward of ``n`` images (the port's
    ``bench.forward_flops`` for the conv stem, whose widths it takes from
    the spec, [features / 2, features, features]; here they are the
    configuration's ``stem_channels``): stem convolution, every
    block, the heads (2 per multiply-add) and the merges' and re-injections'
    additions (1 per element); batch norms folded, biases, ReLUs and pools
    not counted."""
    h, w = input_shape
    f, K = spec["features"], spec["num_classes"]
    h2, w2 = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    th, tw = trunk_shape(spec, input_shape)
    out = {"stem": 2 * h2 * w2 * 49 * 3 * spec["stem_channels"][0],
           "blocks": sum(block_flops(*b) for b in blocks(spec, input_shape)),
           "heads": 0, "adds": 0}

    def merge_adds(hh, ww, d):
        return hh * ww * f + (merge_adds(hh // 2, ww // 2, d - 1) if d > 1 else 0)

    for s in range(spec["num_stacks"]):
        out["adds"] += merge_adds(th, tw, spec["depth"])
        heads = f * f + f * K                                     # feat, score
        if s < spec["num_stacks"] - 1:
            heads += f * f + K * f                                # remap_feat, remap_score
            out["adds"] += 2 * th * tw * f
        out["heads"] += 2 * th * tw * heads
    out = {key: v * n for key, v in out.items()}
    out["total"] = sum(out.values())
    return out


@lru_cache(maxsize=16)
def resize_taps_width(n_in: int, n_out: int) -> int:
    """The widest run of non-zero weights of one axis of the antialiased
    bilinear resize (a triangle filter widened by the downscale factor)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    support = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    nonzero = (np.maximum(0.0, 1.0 - x / support) > 0).T          # (n_out, n_in)
    first = nonzero.argmax(axis=1)
    last = n_in - 1 - nonzero[:, ::-1].argmax(axis=1)
    return int((last - first).max()) + 1


def preprocess_flops(n: int, image_hw: Tuple[int, int], out_shape: Tuple[int, int]) -> int:
    """The separable resize's taps, 2 FLOPs each, over 3 channels: the H
    pass at the input width, the W pass at the output size."""
    (h_in, w_in), (h_out, w_out) = image_hw, out_shape
    kh, kw = resize_taps_width(h_in, h_out), resize_taps_width(w_in, w_out)
    return 2 * 3 * n * (h_out * w_in * kh + h_out * w_out * kw)


def preprocess_bytes(n: int, image_hw: Tuple[int, int], out_shape: Tuple[int, int]) -> int:
    """The uint8 frames read once and the float32 network input written once."""
    return n * 3 * (image_hw[0] * image_hw[1] + F32 * out_shape[0] * out_shape[1])


def call_flops(cfg: dict, T: int) -> int:
    """FLOPs of one pipeline call on T frames of every camera: the forward
    and the preprocess (registration, decode, assembly and DLT are under
    1e-4 of it and not counted)."""
    n = T * cfg["num_cameras"]
    shape = tuple(cfg["spec"]["input_shape"])
    return (forward_flops(cfg["spec"], n, shape)["total"]
            + preprocess_flops(n, tuple(cfg["image_hw"]), shape))
