"""The folded inference bottleneck: weight fold, plain version, CUDA wrapper.

Counterpart of ``deepfly3d_tpu/ops/pallas/bottleneck.py``.  At inference
each of the hourglass's pre-activation bottleneck blocks collapses, with its
three batch norms folded, to

    a1 = relu(x * s1 + t1)
    a2 = relu(a1 @ w1 + b1)
    a3 = relu(conv3x3(a2, w2) + b2)
    y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp  or  x @ wp + bp)

(the last form, the raw-input projection, for a spec with
``proj_from_raw``: the folded dict then holds the flag ``"proj_raw"``)

A bfloat16 net (``fold_bottleneck(..., dtype="bfloat16")``, the JAX fold at
``dtype=jnp.bfloat16``) keeps s1, t1 and the four weights in bfloat16 and the
biases in float32, and its blocks take and give bfloat16 tensors.  Every
product has bfloat16 operands and float32 sums, and the block rounds to
bfloat16 (round to nearest even) exactly where ``bottleneck_xla`` casts:

    a1 = bf16(relu(bf16(bf16(x * s1) + t1)))
    a2 = bf16(relu(a1 @ w1 + b1))
    a3 = bf16(relu(conv3x3(a2, w2) + b2))
    y  = bf16((a3 @ w3 + b3) + (x  or  a1 @ wp + bp  or  x @ wp + bp))

``fold_bottleneck`` builds the folded arrays exactly as the JAX package
does (float64 fold, float32 result); ``bottleneck_plain`` is the plain
PyTorch version (the counterpart of ``bottleneck_xla``); ``fused_bottleneck``
runs the kernels on a CUDA tensor and the plain version on a CPU tensor.

The float32 kernels compute their four products on the tensor cores as
error-compensated TF32: each float32 operand is split into ``hi`` (its low
13 mantissa bits cleared, a TF32 number) and ``lo = tf32(x - hi)``, and a
product is ``a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi`` summed in float32.
``split_tf32`` is that split, ``bottleneck_tf32_model`` the block in this
arithmetic in plain PyTorch (for tests; no path runs it), ``pack_bottleneck``
lays the folded weights out once per block on the host, and ``choose_tile``
picks a thread block's output tile for an image size and batch.

The fly networks' float32 blocks (96->48->96, the projecting 48->48->96, and
64->32->64, 32->32->64 at 64 features) run ``csrc/bottleneck.cu`` on wgmma.
Bound: operations, three TF32 products per multiply, 1.59x the bytes bound
of a 96->48->96 block (PERF.md holds its measured time beside that floor).
w1, w3 and wp stay resident in shared memory as hi and lo, and the 3x3's w2
(162 KB as hi and lo at Cmid 48) streams from L2 through a ring of one tap
per chunk.  ``pack_bottleneck`` gives it the fly layout (``sections_fly``):
s1, t1, b1, b2 and b3 (+ bp) as float32, then w1, w3 and wp (the resident
part) and w2 (as (9*Cmid, Cmid), tap-major), every weight in one pass over
its columns, each k step of 8 holding the weights' TF32 hi half and then
their lo half (``w - hi``, exact) in wgmma's K-major core-matrix order
without swizzle (``_pack_tf32``); w1 and wp in the "quad" k order (a lane
reads 16 bytes of a pixel for two k steps), w2 and w3 in the "pair" order.
``smem_bytes`` mirrors the kernel's shared memory, and ``choose_tile`` reads
its table, ``_TILE_US``.

The 128-wide networks' float32 blocks (128->64->128 and the projecting
64->64->128, ``streams_w2``) run ``csrc/bottleneck_128.cu``, the same design
in passes of 64 columns: ``pack_bottleneck`` gives it the 128-wide layout
(``sections_128``): the vectors, then w1, w3, w2 and wp.  The vectors, w1 and
a projecting block's w3 stay resident in shared memory; w2, the identity
block's w3 and wp stream through a ring of 16 KB chunks (``smem_bytes``), and
``choose_tile`` reads the kernel's own table, ``_TILE_US_128``.

A bfloat16 block runs ``csrc/bottleneck_bf16.cu`` instead: one bf16 wgmma per
k step of each product (bf16 products are exact in float32, so nothing is
split), and ``pack_bottleneck`` gives it a byte buffer (the bf16 resident
layout): s1 and t1 as bf16, the biases as float32, then the four weights as
bf16 in wgmma's K-major core-matrix order without swizzle (``_pack_core16``).
Every width of ``INSTANCES`` keeps all its weights resident at bf16 (109-117
KB for the 128-wide blocks), so no bf16 instance streams w2; beside them a
thread block holds a ring of x halo tiles and one a2 buffer per consumer
warpgroup (``smem_bytes``), and ``choose_tile`` reads the instances' own
table, ``_TILE_US_BF16``.  The plain version computes each product as a
float32 matmul of bfloat16-valued tensors (a PyTorch bf16 matmul would round
its output before the float32 bias, and JAX does not).

Every other width inside ``ENVELOPE`` (Cin, Cout <= 512, Cmid <= 256: every
block of a spec with 8 to 512 features, the converter's 256-wide default
among them) runs ``csrc/bottleneck_general.cu``, float32 (3xTF32) or
bfloat16, whose widths are runtime arguments: ``kernel_for`` says which
kernel a block runs and raises past the envelope.  Its packed buffer is the
general layout (``pack_bottleneck``): every weight with k padded to the
wgmma's k (8 at float32, 16 at bfloat16) and columns to 64, zero-filled, in
passes of 128 columns, each pass k step after k step in wgmma's canonical
K-major layout (``_pack_wgmma``), so that a ring chunk of ``GENERAL_STEPS``
consecutive k steps is one block that one bulk copy moves; at float32 every
k step holds the weights' TF32 hi half and then their lo half (``w - hi``,
exact).  Then s1, t1, b1, b2, b3 and bp as float32 at the padded widths.  No
weight is resident: the kernel streams all four from L2 through a ring of
chunks, and holds a2 and a3 of one output tile in shared memory
(``smem_bytes``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from deepfly3d_torch.ops import _build

BN_EPS = 1e-5  # flax.linen.BatchNorm default

# one thread block's output tile is at most 16 pixels wide
TILE_MAX_WIDTH = 16
NUM_SMS = 132                     # H100 SXM
MAX_SMEM = 227 * 1024             # bytes one thread block can use
# (Cin, Cmid, Cout, projects) the kernels are instantiated for: the 96- and
# 64-wide fly networks' blocks (csrc/bottleneck.cu at float32), and the
# 128-wide h36m network's (csrc/bottleneck_128.cu at float32, ``streams_w2``);
# every width at bf16 in csrc/bottleneck_bf16.cu.  Each projecting instance is
# also built with the raw-input projection.
INSTANCES = ((96, 48, 96, False), (48, 48, 96, True), (64, 32, 64, False), (32, 32, 64, True),
             (128, 64, 128, False), (64, 64, 128, True))
# Every other width inside this envelope runs the general instance
# (csrc/bottleneck_general.cu), whose tiles hold at most GENERAL_TILE_PIXELS
# pixels per dtype (one pass of its two consumer warpgroups: one m64 row block
# each at float32, two at bf16); past it the wrapper raises on the card.
ENVELOPE = {"cin": 512, "cmid": 256, "cout": 512}
GENERAL_TILE_PIXELS = {"float32": 128, "bfloat16": 256}
_TF32_MASK = -8192                # 0xffffe000 as int32: clears 13 mantissa bits
DTYPES = ("float32", "bfloat16")  # the compute dtypes a folded block comes in
_WEIGHTS = ("s1", "t1", "w1", "w2", "w3", "wp")    # in the compute dtype; biases stay float32


def check_dtype(dtype: str) -> torch.dtype:
    """A compute dtype name -> its torch dtype; ValueError for any other name."""
    if str(dtype) not in DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: the port computes in {DTYPES}")
    return getattr(torch, str(dtype))


def bn_affine(scale, bias, mean, var, eps: float = BN_EPS):
    """BatchNorm at inference is x*s + t; return (s, t) as float32 numpy."""
    s = np.asarray(scale, np.float64) / np.sqrt(np.asarray(var, np.float64) + eps)
    t = np.asarray(bias, np.float64) - np.asarray(mean, np.float64) * s
    return s.astype(np.float32), t.astype(np.float32)


def fold_bottleneck(params: Dict, stats: Dict, proj_from_raw: bool = False,
                    dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """Fold one block's batch norms; arrays as the JAX ``fold_bottleneck``.

    ``params``/``stats`` are one Bottleneck's numpy collections (bn1..bn3,
    conv1..conv3, optional proj).  Returns CPU tensors: s1/t1 (1, Cin); w1
    (Cin, Cmid); w2 (9, Cmid, Cmid); w3 (Cmid, Cout); biases (1, C); wp (Cin,
    Cout) and bp (1, Cout) when the block projects, and then with
    ``proj_from_raw`` the flag ``proj_raw`` (a 0-d bool tensor whose presence
    says that the projection reads x, not a1).  The biases are float32; s1,
    t1 and the weights are in ``dtype`` ("float32" or "bfloat16"), rounded
    once from the float64 fold as JAX rounds them (s1 and t1 from float32).
    """
    tdtype = check_dtype(dtype)
    s1, t1 = bn_affine(**params["bn1"], **stats["bn1"])
    s2, t2 = bn_affine(**params["bn2"], **stats["bn2"])
    s3, t3 = bn_affine(**params["bn3"], **stats["bn3"])

    w1 = np.asarray(params["conv1"]["kernel"], np.float64)[0, 0]
    b1 = np.asarray(params["conv1"]["bias"], np.float64)
    w2 = np.asarray(params["conv2"]["kernel"], np.float64)
    b2 = np.asarray(params["conv2"]["bias"], np.float64)
    w3 = np.asarray(params["conv3"]["kernel"], np.float64)[0, 0]
    b3 = np.asarray(params["conv3"]["bias"], np.float64)
    out = {
        "s1": s1[None, :],
        "t1": t1[None, :],
        "w1": w1 * s2[None, :],
        "b1": (b1 * s2 + t2)[None, :],
        "w2": (w2 * s3[None, None, None, :]).reshape(9, w2.shape[2], w2.shape[3]),
        "b2": (b2 * s3 + t3)[None, :],
        "w3": w3,
        "b3": b3[None, :],
    }
    if "proj" in params:
        out["wp"] = np.asarray(params["proj"]["kernel"], np.float64)[0, 0]
        out["bp"] = np.asarray(params["proj"]["bias"], np.float64)[None, :]
    folded = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}
    if tdtype != torch.float32:
        folded.update({k: torch.from_numpy(np.ascontiguousarray(out[k])).to(tdtype)
                       for k in _WEIGHTS if k in out})
    if proj_from_raw and "proj" in params:
        folded["proj_raw"] = torch.ones((), dtype=torch.bool)
    return folded


def _proj_input(x: torch.Tensor, a1: torch.Tensor, folded: Dict[str, torch.Tensor]):
    """What the skip projection reads: x with the raw-input flag, else a1."""
    return x if "proj_raw" in folded else a1


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to its nearest bfloat16 value (ties to even), kept in float32."""
    return t.to(torch.bfloat16).float()


def bottleneck_plain(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the block (matmuls + one F.conv2d), in x's
    dtype: float32, or bfloat16 with the roundings of ``bottleneck_xla``."""
    if x.dtype == torch.bfloat16:
        return _bottleneck_plain_bf16(x, folded)
    a1 = torch.relu(x * folded["s1"][0] + folded["t1"][0])
    a2 = torch.relu(a1 @ folded["w1"] + folded["b1"][0])
    cmid = folded["w2"].shape[1]
    w2 = folded["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)   # OIHW
    z2 = F.conv2d(a2.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    a3 = torch.relu(z2 + folded["b2"][0])
    z3 = a3 @ folded["w3"] + folded["b3"][0]
    if "wp" in folded:
        res = _proj_input(x, a1, folded) @ folded["wp"] + folded["bp"][0]
    else:
        res = x
    return (z3 + res).contiguous()


def _bottleneck_plain_bf16(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The bfloat16 block: float32 products of bf16-valued tensors, each
    rounding where the JAX oracle casts (module docstring)."""
    f = {k: v.float() for k, v in folded.items() if k not in ("packed", "proj_raw")}
    xf = x.float()
    a1 = torch.relu(round_bf16(round_bf16(xf * f["s1"][0]) + f["t1"][0]))
    a2 = round_bf16(torch.relu(a1 @ f["w1"] + f["b1"][0]))
    cmid = f["w2"].shape[1]
    w2 = f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)   # OIHW
    z2 = F.conv2d(a2.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    a3 = round_bf16(torch.relu(z2 + f["b2"][0]))
    z3 = a3 @ f["w3"] + f["b3"][0]
    if "wp" in f:
        res = _proj_input(xf, a1, folded) @ f["wp"] + f["bp"][0]
    else:
        res = xf
    return (z3 + res).to(torch.bfloat16).contiguous()


def split_tf32(x: torch.Tensor):
    """float32 -> (hi, lo): ``hi`` keeps 10 mantissa bits (a TF32 number),
    ``lo`` is ``x - hi`` cut to TF32 the same way; ``hi + lo`` is within
    2^-20 of ``x``, relative."""
    def cut(v):
        return (v.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)

    hi = cut(x)
    return hi, cut(x - hi)


def bottleneck_tf32_model(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                          compensated: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: every product as
    ``a_lo·w_hi + a_hi·w_lo + a_hi·w_hi`` (small terms first, float32 sums),
    everything else float32.  ``compensated=False`` keeps ``a_hi·w_hi`` only
    (plain TF32), the control that shows what the two small terms buy."""
    def product(a, w, op):
        a_hi, a_lo = split_tf32(a)
        w_hi, w_lo = split_tf32(w)
        if not compensated:
            return op(a_hi, w_hi)
        return (op(a_lo, w_hi) + op(a_hi, w_lo)) + op(a_hi, w_hi)

    def conv3x3(a, w):
        return F.conv2d(a.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    a1 = torch.relu(x * folded["s1"][0] + folded["t1"][0])
    a2 = torch.relu(product(a1, folded["w1"], torch.matmul) + folded["b1"][0])
    cmid = folded["w2"].shape[1]
    w2 = folded["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)   # OIHW
    a3 = torch.relu(product(a2, w2, conv3x3) + folded["b2"][0])
    z3 = product(a3, folded["w3"], torch.matmul) + folded["b3"][0]
    if "wp" in folded:
        res = product(_proj_input(x, a1, folded), folded["wp"], torch.matmul) + folded["bp"][0]
    else:
        res = x
    return (z3 + res).contiguous()


def kernel_for(cin: int, cmid: int, cout: int, has_proj: bool) -> str:
    """Which kernel runs a block on the card: ``"instance"`` (a width of
    ``INSTANCES``, csrc/bottleneck.cu or bottleneck_bf16.cu) or
    ``"general"`` (csrc/bottleneck_general.cu); ValueError past ``ENVELOPE``."""
    if not _general(cin, cmid, cout, has_proj):
        return "instance"
    if not (1 <= cin <= ENVELOPE["cin"] and 1 <= cmid <= ENVELOPE["cmid"]
            and 1 <= cout <= ENVELOPE["cout"]):
        raise ValueError(f"block Cin={cin}, Cmid={cmid}, Cout={cout} is past the bottleneck "
                         f"kernel's envelope (Cin <= {ENVELOPE['cin']}, Cmid <= "
                         f"{ENVELOPE['cmid']}, Cout <= {ENVELOPE['cout']})")
    return "general"


def _general(cin: int, cmid: int, cout: int, has_proj: bool) -> bool:
    """Whether a block of these widths has the general layout."""
    return (cin, cmid, cout, has_proj) not in INSTANCES


def _k_granule(dtype: str) -> int:
    """k of one MMA of the general instance: 8 (TF32) or 16 (bf16)."""
    return 16 if dtype == "bfloat16" else 8


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def _padded(a: np.ndarray, shape) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


# The general instance (csrc/bottleneck_general.cu): a pass covers 128
# columns, padded to 64; a ring chunk holds GENERAL_STEPS k steps (half as many
# over bf16's passes of 256 rows, on tiles of more than 128 pixels), and the
# ring GENERAL_STAGES chunks per dtype; mbarriers take the first 128 bytes.
GENERAL_COLS = 128
GENERAL_STEPS = 4
GENERAL_STAGES = {"float32": 4, "bfloat16": 8}


def _k_perm(dtype: str) -> np.ndarray:
    """(2, E): the channel of a k step that element j of core-matrix half kc
    holds (E = 4 float32 / 8 bf16 values of 16 bytes).  wgmma's A fragment
    gives lane column t the k slots (t, t+4) at TF32 and (2t, 2t+1, 2t+8,
    2t+9) at bf16; the order puts them on channels 2t, 2t+1 / 4t ... 4t+3, so
    that a lane reads its k step as eight contiguous bytes of a pixel."""
    j = np.arange(8 if dtype == "bfloat16" else 4)
    if dtype == "bfloat16":
        return np.stack([4 * (j // 2) + j % 2, 4 * (j // 2) + 2 + j % 2])
    return np.stack([2 * j, 2 * j + 1])


def _pack_wgmma(w: np.ndarray, kp: int, n: int, dtype: str) -> np.ndarray:
    """(K, N) weight -> flat float32 values of the general layout: zero-padded
    to (kp, n); per pass of GENERAL_COLS columns, per k step, the core
    matrices (8 columns x 16 bytes of k, ``_k_perm``'s channels) as
    [column group][k half][column][element]; at float32 each k step holds
    that for hi, then for lo = w - hi (so hi + lo == w bit for bit)."""
    k = _k_granule(dtype)
    e = k // 2
    steps = kp // k
    arr = _padded(w, (kp, n)).reshape(steps, k, n)[:, _k_perm(dtype), :]   # (s, kc, j, n)
    out = []
    for n0 in range(0, n, GENERAL_COLS):
        nc = min(GENERAL_COLS, n - n0)
        core = arr[..., n0:n0 + nc].reshape(steps, 2, e, nc // 8, 8).transpose(0, 3, 1, 4, 2)
        core = np.ascontiguousarray(core, np.float32)
        if dtype == "float32":
            hi = (core.view(np.int32) & _TF32_MASK).view(np.float32)
            core = np.stack([hi, core - hi], axis=1)
        out.append(core.reshape(-1))
    return np.concatenate(out)


def _pack_core16(w: np.ndarray, permute: bool) -> np.ndarray:
    """(K, N) weight, K a multiple of 16 and N of 8 -> flat values of the bf16
    resident layout: per k step of 16, wgmma's K-major core matrices without
    swizzle as [N/8 column groups][2 k halves][8 columns][8 values].  With
    ``permute`` each k step's channels are in ``_k_perm("bfloat16")``'s order
    (A read by lanes from a pixel's channels); without, in plain order (A read
    by wgmma from shared memory, or an accumulator fragment)."""
    k, n = w.shape
    if permute:
        arr = w.reshape(k // 16, 16, n)[:, _k_perm("bfloat16"), :]       # (s, kc, j, n)
    else:
        arr = w.reshape(k // 16, 2, 8, n)
    core = arr.reshape(k // 16, 2, 8, n // 8, 8).transpose(0, 3, 1, 4, 2)
    return np.ascontiguousarray(core, np.float32).reshape(-1)


# The float32 instances on wgmma, the fly widths (csrc/bottleneck.cu) and the
# 128-wide (csrc/bottleneck_128.cu): k steps of 8, each holding hi and then lo;
# tiles of at most RING_TILE_PIXELS pixels (two m64 row blocks in the 3x3) and
# RING_HALO_PIXELS halo pixels (three in stage 1).  The fly instances keep each
# weight in one pass over its columns, stream w2 through a ring of one tap per
# chunk, FLY_STAGES slots at least and at most, behind FLY_BAR_BYTES of
# mbarriers; the 128-wide instances keep passes of WIDE_COLS columns and a ring
# of WIDE_CHUNK-byte chunks (4 k steps), WIDE_STAGES slots.
RING_TILE_PIXELS = 128
RING_HALO_PIXELS = 192
FLY_STAGES = (2, 3)
FLY_BAR_BYTES = 128
WIDE_COLS = 64
WIDE_CHUNK = 16384
WIDE_STAGES = (3, 6)


def _pack_tf32(w: np.ndarray, order: str, cols: int = WIDE_COLS) -> np.ndarray:
    """(K, N) float32 weight, K a multiple of 16 and N of ``cols`` -> flat
    float32 values of the wgmma layouts: per pass of ``cols`` columns, per k
    step of 8, the hi values and then the lo values (``w - hi``, so hi + lo ==
    w bit for bit), each as wgmma's K-major core matrices without swizzle,
    [cols/8 column groups][2 k halves][8 columns][4 values].  Element j of k
    half kc of step s is channel 8s + 2j + kc (``"pair"``: A an accumulator
    fragment, or read 8 bytes a lane) or 16 (s // 2) + 4j + 2 (s % 2) + kc
    (``"quad"``: a lane reads 16 bytes of a pixel for steps 2J and 2J+1)."""
    k, n = w.shape
    s = np.arange(k // 8)[:, None, None]
    kc = np.arange(2)[None, :, None]
    j = np.arange(4)[None, None, :]
    ch = 8 * s + 2 * j + kc if order == "pair" else 16 * (s // 2) + 4 * j + 2 * (s % 2) + kc
    arr = np.asarray(w, np.float32)[ch]                                  # (s, kc, j, n)
    out = []
    for n0 in range(0, n, cols):
        core = arr[..., n0:n0 + cols].reshape(k // 8, 2, 4, cols // 8, 8)
        core = np.ascontiguousarray(core.transpose(0, 3, 1, 4, 2))         # (s, grp, kc, col, j)
        hi = (core.view(np.int32) & _TF32_MASK).view(np.float32)
        out.append(np.stack([hi, core - hi], axis=1).reshape(-1))
    return np.concatenate(out)


def _sections(sizes) -> Dict[str, tuple]:
    """[(name, bytes)] laid end to end -> {name: (byte offset, bytes)}, the
    empty ones left out."""
    out, at = {}, 0
    for name, nbytes in sizes:
        if nbytes:
            out[name] = (at, nbytes)
        at += nbytes
    return out


def sections_fly(cin: int, cmid: int, cout: int, has_proj: bool) -> Dict[str, tuple]:
    """{name: (byte offset, bytes)} of a fly float32 instance's packed buffer
    (``pack_bottleneck``; the kernel's ``packed_layout``): s1, t1, b1, b2, b3
    (+ bp), then w1, w3, wp (the resident part) and w2 (streamed), the
    weights as hi and lo (8 bytes a weight); wp only where the block projects."""
    return _sections([("s1", 4 * cin), ("t1", 4 * cin), ("b1", 4 * cmid), ("b2", 4 * cmid),
                      ("b3", 4 * cout), ("w1", 8 * cin * cmid), ("w3", 8 * cmid * cout),
                      ("wp", 8 * cin * cout if has_proj else 0), ("w2", 8 * 9 * cmid * cmid)])


def _pack_fly(f: Dict[str, np.ndarray]) -> torch.Tensor:
    """``pack_bottleneck``'s fly layout (``sections_fly``)."""
    cmid, cout = f["w1"].shape[1], f["w3"].shape[1]
    b3 = f["b3"][0] + f["bp"][0] if "wp" in f else f["b3"][0]
    parts = [f["s1"][0], f["t1"][0], f["b1"][0], f["b2"][0], b3,
             _pack_tf32(f["w1"], "quad", cmid), _pack_tf32(f["w3"], "pair", cout)]
    if "wp" in f:
        parts.append(_pack_tf32(f["wp"], "quad", cout))
    parts.append(_pack_tf32(f["w2"].reshape(9 * cmid, cmid), "pair", cmid))
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def sections_128(cin: int, has_proj: bool) -> Dict[str, tuple]:
    """{name: (byte offset, bytes)} of a 128-wide float32 instance's packed
    buffer (``pack_bottleneck``; the kernel's ``packed_layout``): s1, t1, b1,
    b2, b3 (+ bp), then w1, w3 (the resident part), w2 and wp (streamed), the
    weights as hi and lo (8 bytes a weight); wp only where the block projects."""
    return _sections([("s1", 4 * cin), ("t1", 4 * cin), ("b1", 4 * 64), ("b2", 4 * 64),
                      ("b3", 4 * 128), ("w1", 8 * cin * 64), ("w3", 8 * 64 * 128),
                      ("w2", 8 * 9 * 64 * 64), ("wp", 8 * cin * 128 if has_proj else 0)])


def _pack_128(f: Dict[str, np.ndarray]) -> torch.Tensor:
    """``pack_bottleneck``'s 128-wide layout (``sections_128``)."""
    cmid = f["w1"].shape[1]
    b3 = f["b3"][0] + f["bp"][0] if "wp" in f else f["b3"][0]
    parts = [f["s1"][0], f["t1"][0], f["b1"][0], f["b2"][0], b3,
             _pack_tf32(f["w1"], "quad"), _pack_tf32(f["w3"], "pair"),
             _pack_tf32(f["w2"].reshape(9 * cmid, cmid), "pair")]
    if "wp" in f:
        parts.append(_pack_tf32(f["wp"], "quad"))
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def _general_widths(cin: int, cmid: int, cout: int, dtype: str):
    """(cinp, cmidp, cmidn, coutn): k padded to the wgmma's k, n to 64."""
    k = _k_granule(dtype)
    return _ceil(cin, k), _ceil(cmid, k), _ceil(cmid, 64), _ceil(cout, 64)


def _pack_general(f: Dict[str, np.ndarray], dtype: str) -> torch.Tensor:
    """``pack_bottleneck``'s general layout (module docstring)."""
    cin, cmid = f["w1"].shape
    cout = f["w3"].shape[1]
    cinp, cmidp, cmidn, coutn = _general_widths(cin, cmid, cout, dtype)
    w2 = _padded(f["w2"], (9, cmidp, cmidn)).reshape(9 * cmidp, cmidn)      # tap-major
    mats = [(f["w1"], cinp, cmidn), (w2, 9 * cmidp, cmidn), (f["w3"], cmidp, coutn)]
    vectors = [_padded(f["s1"][0], (cinp,)), _padded(f["t1"][0], (cinp,)),
               _padded(f["b1"][0], (cmidn,)), _padded(f["b2"][0], (cmidn,)),
               _padded(f["b3"][0], (coutn,))]
    if "wp" in f:
        mats.append((f["wp"], cinp, coutn))
        vectors.append(_padded(f["bp"][0], (coutn,)))
    weights = np.concatenate([_pack_wgmma(w, kp, n, dtype) for w, kp, n in mats])
    v = np.concatenate(vectors).astype(np.float32)
    if dtype == "float32":
        return torch.from_numpy(np.concatenate([weights, v]).astype(np.float32))
    w = torch.from_numpy(weights).to(torch.bfloat16)                  # exact: bf16 values
    return torch.cat([w.view(torch.uint8), torch.from_numpy(v).view(torch.uint8)])


def pack_bottleneck(folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's weight buffer of one block, a flat CPU tensor.

    float32 block: float32 values, the fly layout (``sections_fly``): s1,
    t1, b1, b2 and b3 (+ bp), then w1, w3, wp and w2 (as (9*Cmid, Cmid),
    tap-major), each weight as hi and lo in wgmma's core-matrix order
    (``_pack_tf32``); a block of the 128-wide instances (``streams_w2``) the
    128-wide layout (``sections_128``).

    bfloat16 block: bytes (uint8), s1 and t1 as bf16, b1, b2, b3 and bp as
    float32 (bp kept apart from b3, as the JAX oracle adds it), then w1, w2
    (as (9*Cmid, Cmid), tap-major), w3 and wp as bf16 in the core-matrix
    order of ``_pack_core16`` (w1 and wp permuted, w2 and w3 plain).  Every
    section starts 16-byte aligned (the widths are multiples of 16).

    A width outside ``INSTANCES`` gets the general layout (module
    docstring): float32 values, or bytes at bfloat16, bp apart in both.
    """
    f = {k: v.detach().cpu().float().numpy() for k, v in folded.items()
         if k not in ("packed", "proj_raw")}
    cin, cmid = f["w1"].shape
    dtype = "bfloat16" if folded["w1"].dtype == torch.bfloat16 else "float32"
    if _general(cin, cmid, f["w3"].shape[1], "wp" in f):
        return _pack_general(f, dtype)
    if streams_w2(cin, cmid, f["w3"].shape[1], "wp" in f, dtype):
        return _pack_128(f)
    if dtype == "bfloat16":
        weights = [_pack_core16(f["w1"], True), _pack_core16(f["w2"].reshape(9 * cmid, cmid), False),
                   _pack_core16(f["w3"], False)]
        biases = [f["b1"][0], f["b2"][0], f["b3"][0]]
        if "wp" in f:
            weights.append(_pack_core16(f["wp"], True))
            biases.append(f["bp"][0])
        bn1 = torch.from_numpy(np.concatenate([f["s1"][0], f["t1"][0]])).to(torch.bfloat16)
        w = torch.from_numpy(np.concatenate(weights)).to(torch.bfloat16)  # exact: bf16 values
        b = torch.from_numpy(np.concatenate(biases).astype(np.float32))
        return torch.cat([bn1.view(torch.uint8), b.view(torch.uint8), w.view(torch.uint8)])
    return _pack_fly(f)


def add_packed(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``folded`` plus its ``"packed"`` weight buffer, which the kernel reads."""
    return {**folded, "packed": pack_bottleneck(folded)}


def bf16_sections(cin: int, cmid: int, cout: int, has_proj: bool) -> Dict[str, tuple]:
    """{name: (byte offset, bytes)} of a bf16 resident instance's packed buffer
    (``pack_bottleneck``; the kernel's ``packed_layout``): s1, t1 (bf16), b1,
    b2, b3, bp (float32), w1, w2, w3, wp (bf16); bp and wp only where the
    block projects."""
    return _sections([("s1", 2 * cin), ("t1", 2 * cin), ("b1", 4 * cmid), ("b2", 4 * cmid),
                      ("b3", 4 * cout), ("bp", 4 * cout if has_proj else 0),
                      ("w1", 2 * cin * cmid), ("w2", 2 * 9 * cmid * cmid),
                      ("w3", 2 * cmid * cout), ("wp", 2 * cin * cout if has_proj else 0)])


def packed_size(cin: int, cmid: int, cout: int, has_proj: bool, dtype: str = "float32") -> int:
    """Length of a block's packed weight buffer: float32 values for a
    float32 block, bytes for a bfloat16 block (2-byte weights, 4-byte
    vectors, bp apart from b3); the general layout at its padded widths,
    with bp apart at float32 too and every float32 weight twice (hi, lo);
    the fly and 128-wide layouts with every weight twice (hi, lo)."""
    if _general(cin, cmid, cout, has_proj):
        cinp, cmidp, cmidn, coutn = _general_widths(cin, cmid, cout, dtype)
        weights = cinp * cmidn + 9 * cmidp * cmidn + cmidp * coutn + (cinp * coutn if has_proj
                                                                      else 0)
        vectors = 2 * cinp + 2 * cmidn + coutn + (coutn if has_proj else 0)
        # float32: hi and lo values; bf16: 2-byte weights
        return 2 * weights + (4 * vectors if dtype == "bfloat16" else vectors)
    if dtype == "bfloat16":
        return sum(n for _, n in bf16_sections(cin, cmid, cout, has_proj).values())
    sections = sections_128(cin, has_proj) if streams_w2(cin, cmid, cout, has_proj) \
        else sections_fly(cin, cmid, cout, has_proj)
    return sum(n for _, n in sections.values()) // 4


def streams_w2(cin: int, cmid: int, cout: int, has_proj: bool, dtype: str = "float32") -> bool:
    """Whether a float32 block is one of the 128-wide instances (Cmid 64):
    with w1 and w3 (and wp) resident as hi and lo, the fly design's whole-tap
    ring (32 KB a slot) no longer fits beside an 8x16 tile's a2, so they run
    ``csrc/bottleneck_128.cu``, which keeps w1 resident and streams w2 in
    chunks of half a tap (and w3 or wp); the fly instances run
    ``csrc/bottleneck.cu``.  A bfloat16 instance never does (the general
    instance streams every weight, whatever this says)."""
    if dtype == "bfloat16" or (cin, cmid, cout, has_proj) not in INSTANCES:
        return False
    return cmid == 64


def _layout_128(cin: int, th: int, tw: int, has_proj: bool):
    """(shared memory bytes, ring slots) of a 128-wide float32 instance's thread
    block (the kernel's ``make_layout``): 128 bytes of mbarriers, the resident
    vectors and w1 (and w3 of a projecting block; the identity block streams
    it), as many ring slots of WIDE_CHUNK bytes as fit up to WIDE_STAGES[1]
    (counted as at least WIDE_STAGES[0]), and a2 on the (th+2) x (tw+2) halo
    tile, 64 float32 values a pixel, to 128 bytes."""
    ring = 128 + sections_128(cin, has_proj)["w2" if has_proj else "w3"][0]
    a2 = _ceil((th + 2) * (tw + 2) * 64 * 4, 128)
    stages = min(WIDE_STAGES[1], max(WIDE_STAGES[0], (MAX_SMEM - ring - a2) // WIDE_CHUNK))
    return ring + stages * WIDE_CHUNK + a2, stages


def tile_fits_128(th: int, tw: int, cin: int, has_proj: bool) -> bool:
    """Whether the 128-wide float32 instance launches a th x tw tile (the
    kernel's refusals): at most RING_TILE_PIXELS pixels, RING_HALO_PIXELS halo
    pixels, and three ring slots within one thread block's shared memory."""
    return (th * tw <= RING_TILE_PIXELS and (th + 2) * (tw + 2) <= RING_HALO_PIXELS
            and _layout_128(cin, th, tw, has_proj)[0] <= MAX_SMEM)


def _layout_fly(cin: int, cmid: int, cout: int, th: int, tw: int, has_proj: bool):
    """(shared memory bytes, ring slots) of a fly float32 instance's thread
    block (the kernel's ``make_layout``): FLY_BAR_BYTES of mbarriers, the
    resident part of ``sections_fly`` (the vectors, w1, w3, wp) to 128 bytes,
    as many ring slots of one tap of w2 (Cmid x Cmid as hi and lo) as fit up
    to FLY_STAGES[1] (counted as at least FLY_STAGES[0]), and a2 on the
    (th+2) x (tw+2) halo tile, Cmid float32 values a pixel, to 128 bytes."""
    ring = FLY_BAR_BYTES + _ceil(sections_fly(cin, cmid, cout, has_proj)["w2"][0], 128)
    a2 = _ceil((th + 2) * (tw + 2) * cmid * 4, 128)
    chunk = 8 * cmid * cmid
    stages = min(FLY_STAGES[1], max(FLY_STAGES[0], (MAX_SMEM - ring - a2) // chunk))
    return ring + stages * chunk + a2, stages


def tile_fits_fly(th: int, tw: int, cin: int, cmid: int, cout: int, has_proj: bool) -> bool:
    """Whether the fly float32 instance launches a th x tw tile (the kernel's
    refusals): at most RING_TILE_PIXELS pixels, RING_HALO_PIXELS halo pixels,
    and two ring slots within one thread block's shared memory."""
    return (th * tw <= RING_TILE_PIXELS and (th + 2) * (tw + 2) <= RING_HALO_PIXELS
            and _layout_fly(cin, cmid, cout, th, tw, has_proj)[0] <= MAX_SMEM)


# The bf16 resident instances (csrc/bottleneck_bf16.cu): a ring of at most
# BF16_STAGES x halo tiles per thread block; the 3x3's output rows lie on the
# halo's row pitch, th * (tw + 2) of them to a whole m64 row block, at most
# three blocks (two at Cmid = 64); the halo has at most BF16_HALO_PIXELS pixels
# (four m64 row blocks of the first stage).
BF16_STAGES = 4
BF16_HALO_PIXELS = 256


def _bf16_blocks(th: int, tw: int):
    """(m64 row blocks of stage 1 over the halo, of the 3x3 and the output) of
    a th x tw tile of a bf16 resident instance."""
    return -(-(th + 2) * (tw + 2) // 64), -(-th * (tw + 2) // 64)


def bf16_tile_fits(th: int, tw: int, cin: int, cmid: int, cout: int, has_proj: bool) -> bool:
    """Whether the bf16 resident instance launches a th x tw tile: its 3x3 has
    at most three m64 row blocks (two at Cmid = 64), its halo at most
    BF16_HALO_PIXELS pixels, and its thread block fits shared memory with two
    ring slots (the kernel's refusals)."""
    return (_bf16_blocks(th, tw)[1] <= (2 if cmid > 48 else 3)
            and (th + 2) * (tw + 2) <= BF16_HALO_PIXELS
            and smem_bytes(cin, cmid, cout, th, tw, has_proj, "bfloat16") <= MAX_SMEM)


def _bf16_layout(cin: int, cmid: int, cout: int, th: int, tw: int, has_proj: bool):
    """(shared memory bytes, ring slots) of a bf16 resident instance's thread
    block (the kernel's ``smem_layout``): 128 bytes of mbarriers, the packed
    buffer, as many x halo slots ((th+2) x (tw+2) x Cin bf16 each) as fit up to
    BF16_STAGES but at least two, and one a2 buffer per consumer warpgroup: Cmid
    bf16 of each row from the halo's first to the 3x3's last tap (its rows,
    th x (tw+2) to 64, + 2 (tw+2) + 2), to 8 rows, and at least room for stage
    3's staging of y (64 rows of one column pass of Cout, or of Cout/2 past 96,
    16 bytes apart); each section 128-byte aligned."""
    hw = tw + 2
    hp = (th + 2) * hw
    m2 = 64 * _bf16_blocks(th, tw)[1]
    r2 = _ceil(max(hp, m2 + 2 * hw + 2), 8)
    ring = _ceil(128 + packed_size(cin, cmid, cout, has_proj, "bfloat16"), 128)
    slot = _ceil(hp * cin * 2, 128)
    n3 = cout // 2 if cout > 96 else cout             # stage 3's column pass
    fixed = ring + 2 * _ceil(max(r2 * cmid * 2, 64 * (2 * n3 + 16)), 128)
    stages = min(BF16_STAGES, max(2, (MAX_SMEM - fixed) // slot))
    return fixed + stages * slot, stages


def smem_bytes(cin: int, cmid: int, cout: int, th: int, tw: int, has_proj: bool,
               dtype: str = "float32") -> int:
    """Dynamic shared memory of one thread block: for a float32 block of the
    fly instances ``_layout_fly``'s, of the 128-wide ones (``streams_w2``)
    ``_layout_128``'s; for a bfloat16 block, ``_bf16_layout``'s: 128 bytes of
    mbarriers, the packed bytes, a ring of x halo tiles and two a2 buffers.
    The general instance: 128 bytes of mbarriers, a ring of
    GENERAL_STAGES chunks (GENERAL_STEPS k steps x 128 columns, hi and lo at
    float32; half the k steps on bf16 tiles of more than 128 pixels), a2 on
    the halo tile at a pitch of Cmid padded to the wgmma's k
    and then to 8 (mod 32) words, and a3 on the tile at the same pitch, over
    a2's bytes where Cmid fits one pass of 128 columns."""
    if _general(cin, cmid, cout, has_proj):
        bf16 = dtype == "bfloat16"
        _, cmidp, cmidn, _ = _general_widths(cin, cmid, cout, dtype)
        e = 2 if bf16 else 4
        p2 = cmidp + ((80 - cmidp % 64) % 64 if bf16 else (40 - cmidp % 32) % 32)
        a2 = _ceil((th + 2) * (tw + 2) * p2 * e, 16)
        a3 = _ceil(th * tw * p2 * e, 16)
        steps = GENERAL_STEPS // (2 if bf16 and th * tw > 128 else 1)
        ring = GENERAL_STAGES[dtype] * steps * (1 if bf16 else 2) * 32 * GENERAL_COLS
        return 128 + ring + (max(a2, a3) if cmidn <= GENERAL_COLS else a2 + a3)
    if dtype == "bfloat16":
        return _bf16_layout(cin, cmid, cout, th, tw, has_proj)[0]
    if streams_w2(cin, cmid, cout, has_proj):
        return _layout_128(cin, th, tw, has_proj)[0]
    return _layout_fly(cin, cmid, cout, th, tw, has_proj)[0]


# Microseconds of one tile of m 16-pixel row tiles (index m, up to
# RING_TILE_PIXELS / 16) of the fly float32 instances (csrc/bottleneck.cu),
# 96->48->96 and 48->48->96 (+proj) blocks: device time of a launch over its
# rounds of one tile per SM, the median over the fly shapes of more than one
# round, ``scripts/bench_torch_kernels.py --tiles`` (its FLY_TILE_TABLE line),
# NVIDIA H100 80GB HBM3 at 700 W.
_TILE_US = (None, 6.53, 7.18, 7.45, 7.86, 10.63, 12.38, 13.07, 14.38)
# The same for the 128-wide float32 instances (csrc/bottleneck_128.cu),
# 128->64->128 and 64->64->128 (+proj) blocks, at the h36m shapes (its
# WIDE_TILE_TABLE line).
_TILE_US_128 = (None, 10.18, 11.20, 11.65, 12.39, 16.01, 19.19, 19.59, 20.12)
# The same for the general instance, float32 256->128->256 and 128->128->256
# (raw projection) blocks, and apart for bf16: the median over the shapes of
# more than one wave, ``scripts/sweep_general_tiles.py`` at the converter's
# 256-wide path (56 x 128x256 ... 8x16), NVIDIA H100 80GB HBM3 at 700 W; up to
# GENERAL_TILE_PIXELS / 16 row tiles, one pass of its consumer warpgroups.  A
# wave is one tile per SM of its persistent thread blocks.
_TILE_US_GENERAL = (None, 49.0, 52.2, 54.2, 55.4, 73.2, 84.1, 85.1, 89.3)
# The bf16 resident instances: microseconds of one consumer warpgroup's tile
# with nb2 m64 row blocks in the 3x3 and the output and nb1 in stage 1
# (``_bf16_blocks``; index [nb2][nb1 - nb2]: the halo has 2 (tw + 2) <= 36
# pixels more than the 3x3's rows, so nb1 is nb2 or nb2 + 1), two such tiles at
# a time per SM (one per consumer warpgroup): the median of launch time over
# rounds of two tiles per SM over the 96->48->96 and 48->48->96 shapes of more
# than one round, ``scripts/bench_torch_kernels.py --tiles`` at the bf16 paths'
# shapes (its BF16_TILE_TABLE line), NVIDIA H100 80GB HBM3 at 700 W.
_TILE_US_BF16 = (None, (4.31, 5.13), (6.96, 7.58), (9.96, 10.37))
_TILE_US_GENERAL_BF16 = (None, 26.7, 27.4, 28.9, 29.9, 36.4, 43.8, 44.5, 46.1, 56.5, 56.1, 58.8,
                         59.6, 74.2, 73.8, 74.8, 81.9)


@lru_cache(maxsize=None)
def choose_tile(n: int, h: int, w: int, cin: int, cmid: int, cout: int, has_proj: bool,
                dtype: str = "float32"):
    """Output tile (rows, cols) of one thread block for an (n, h, w) batch:
    the one whose launch should take least time, waves of thread blocks over
    the SMs times the measured time of such a tile, among those that fit
    shared memory.  Large images get 8x16 tiles; small images and batches
    fewer rows, until one wave covers the launch.  The bfloat16 instances
    have their own rules and table (``_choose_tile_bf16``); the float32
    instances take the tiles that ``tile_fits_fly`` or ``tile_fits_128`` and
    their tables, ``_TILE_US`` and ``_TILE_US_128``; the general instance's
    tiles hold at most GENERAL_TILE_PIXELS[dtype] pixels and use its own
    tables, ``_TILE_US_GENERAL`` and ``_TILE_US_GENERAL_BF16``.  Raises
    ValueError if no tile fits."""
    tw = min(TILE_MAX_WIDTH, w)
    if not _general(cin, cmid, cout, has_proj):
        if dtype == "bfloat16":
            return _choose_tile_bf16(n, h, w, cin, cmid, cout, has_proj)
        if streams_w2(cin, cmid, cout, has_proj):
            fits, tile_us = lambda th: tile_fits_128(th, tw, cin, has_proj), _TILE_US_128
        else:
            fits, tile_us = lambda th: tile_fits_fly(th, tw, cin, cmid, cout, has_proj), _TILE_US
    else:
        tile_us = _TILE_US_GENERAL_BF16 if dtype == "bfloat16" else _TILE_US_GENERAL
        fits = lambda th: (th * tw <= (len(tile_us) - 1) * 16
                           and smem_bytes(cin, cmid, cout, th, tw, has_proj, dtype) <= MAX_SMEM)
    best = None
    for th in range(1, h + 1):
        if not fits(th):
            break
        rounds = -(-n * -(-h // th) * -(-w // tw) // NUM_SMS)
        cost = rounds * tile_us[-(-th * tw // 16)]
        if best is None or cost < best[0]:
            best = (cost, th)
    if best is None:
        raise ValueError(f"block too wide for one thread block's shared memory "
                         f"(Cin={cin}, Cmid={cmid}, Cout={cout})")
    return best[1], tw


def _choose_tile_bf16(n: int, h: int, w: int, cin: int, cmid: int, cout: int,
                      has_proj: bool):
    """``choose_tile`` for a bf16 resident instance: among the tiles that
    ``bf16_tile_fits``, the one whose launch should take least time; a thread
    block runs its tiles two at a time (one per consumer warpgroup), so a
    launch takes ceil(ceil(tiles / NUM_SMS) / 2) times ``_TILE_US_BF16`` of its
    tile."""
    tw = min(TILE_MAX_WIDTH, w)
    best = None
    for th in range(1, h + 1):
        if not bf16_tile_fits(th, tw, cin, cmid, cout, has_proj):
            break
        nb1, nb2 = _bf16_blocks(th, tw)
        per_sm = -(-n * -(-h // th) * -(-w // tw) // NUM_SMS)
        cost = -(-per_sm // 2) * _TILE_US_BF16[nb2][nb1 - nb2]
        if best is None or cost < best[0]:
            best = (cost, th)
    if best is None:
        raise ValueError(f"block too wide for one thread block's shared memory "
                         f"(Cin={cin}, Cmid={cmid}, Cout={cout})")
    return best[1], tw


def _shapes(x: torch.Tensor, folded: Dict[str, torch.Tensor]):
    """-> (Cin, Cmid, Cout, dtype name); raises for a folded block that does
    not fit x, or whose weights are in another dtype than x."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    cin = x.shape[3]
    cmid = folded["w1"].shape[1]
    cout = folded["w3"].shape[1]
    want = {
        "s1": (1, cin), "t1": (1, cin), "w1": (cin, cmid), "b1": (1, cmid),
        "w2": (9, cmid, cmid), "b2": (1, cmid), "w3": (cmid, cout),
        "b3": (1, cout),
    }
    if "wp" in folded:
        want.update(wp=(cin, cout), bp=(1, cout))
    elif cin != cout:
        raise ValueError(f"block without projection needs Cin == Cout ({cin} != {cout})")
    elif "proj_raw" in folded:
        raise ValueError("folded has the raw-input flag but no projection")
    for k, shape in want.items():
        if tuple(folded[k].shape) != shape:
            raise ValueError(f"folded[{k!r}] has shape {tuple(folded[k].shape)}, want {shape}")
    dtype = str(x.dtype).replace("torch.", "")
    check_dtype(dtype)
    for k in _WEIGHTS:
        if k in folded and folded[k].dtype != x.dtype:
            raise ValueError(f"x is {x.dtype} but folded[{k!r}] is {folded[k].dtype}: a block "
                             f"runs in the dtype it was folded for")
    return cin, cmid, cout, dtype


@lru_cache(maxsize=None)
def _kernel(source: str, name: str):
    """The C entry point ``name`` of ``csrc/<source>.cu``."""
    fn = getattr(_build.library(source), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bottleneck(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One folded bottleneck block, (N, H, W, Cin) -> (N, H, W, Cout) in x's
    dtype (float32, or bfloat16 for a block folded at bfloat16).

    On a CUDA tensor this launches ``csrc/bottleneck.cu`` (float32, the fly
    widths), ``csrc/bottleneck_128.cu`` (float32, the 128-wide blocks: ``streams_w2``)
    or ``csrc/bottleneck_bf16.cu`` (bfloat16) at a width of ``INSTANCES``, and
    ``csrc/bottleneck_general.cu`` at any other width inside ``ENVELOPE``
    (one launch, every intermediate on chip; ``folded`` must hold the
    ``"packed"`` buffer of ``add_packed``; the raw-input projection where
    ``folded`` has ``"proj_raw"``), or raises, past the envelope too; on a
    CPU tensor it runs ``bottleneck_plain``.  ``fused_bottleneck.launches``
    counts launches of the float32 instances of ``csrc/bottleneck.cu``,
    ``.launches_128`` those of ``csrc/bottleneck_128.cu``, ``.launches_bf16``
    those of the bfloat16 ones, ``.launches_general`` and
    ``.launches_general_bf16`` those of the general instance.
    """
    cin, cmid, cout, dtype = _shapes(x, folded)
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not {x.device}")
    has_proj = "wp" in folded
    if "packed" not in folded:
        raise ValueError("folded lacks the kernel's weight buffer: pass add_packed(folded)")
    packed = folded["packed"]
    packed_dtype = torch.float32 if dtype == "float32" else torch.uint8
    for name, t, want in (("x", x, x.dtype), ("folded['packed']", packed, packed_dtype)):
        if t.device != x.device or t.dtype != want or not t.is_contiguous():       # what the kernel reads
            raise ValueError(f"{name} must be a contiguous {want} tensor on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    general = kernel_for(cin, cmid, cout, has_proj) == "general"
    wide = streams_w2(cin, cmid, cout, has_proj, dtype)
    if packed.numel() != packed_size(cin, cmid, cout, has_proj, dtype):
        raise ValueError(f"folded['packed'] has {packed.numel()} values: not this block's")
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, cout), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    th, tw = choose_tile(n, h, w, cin, cmid, cout, has_proj, dtype)
    suffix = "_bf16" if dtype != "float32" else ""
    if general:       # (source, its entry point, the launch counter's suffix)
        source, entry, counter = "bottleneck_general", "df3d_bottleneck_general" + suffix, \
            "_general" + suffix
    elif wide:
        source, entry, counter = "bottleneck_128", "df3d_bottleneck_128", "_128"
    else:
        source, entry, counter = "bottleneck" + suffix, "df3d_bottleneck" + suffix, suffix
    with torch.cuda.device(x.device):     # the library asks cudaGetDevice for the SM count
        rc = _kernel(source, entry)(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout,
            int(has_proj), int("proj_raw" in folded), th, tw,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, f"{dtype} bottleneck kernel ({source}.cu)")
    counter = "launches" + counter
    setattr(fused_bottleneck, counter, getattr(fused_bottleneck, counter) + 1)
    return y


fused_bottleneck.launches = 0
fused_bottleneck.launches_128 = 0
fused_bottleneck.launches_bf16 = 0
fused_bottleneck.launches_general = 0
fused_bottleneck.launches_general_bf16 = 0
