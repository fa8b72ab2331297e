"""The folded inference bottleneck: weight fold, plain version, CUDA wrapper.

Counterpart of ``deepfly3d_tpu/ops/pallas/bottleneck.py``.  At inference
each of the hourglass's pre-activation bottleneck blocks collapses, with its
three batch norms folded, to

    a1 = relu(x * s1 + t1)
    a2 = relu(a1 @ w1 + b1)
    a3 = relu(conv3x3(a2, w2) + b2)
    y  = a3 @ w3 + b3 + (x  or  a1 @ wp + bp)

``fold_bottleneck`` builds the folded arrays exactly as the JAX package
does (float64 fold, float32 result); ``bottleneck_plain`` is the plain
PyTorch version (the counterpart of ``bottleneck_xla``); ``fused_bottleneck``
runs ``csrc/bottleneck.cu`` on a CUDA tensor and the plain version on a CPU
tensor.

The kernel computes its four products on the tensor cores as
error-compensated TF32: each float32 operand is split into ``hi`` (its low
13 mantissa bits cleared, a TF32 number) and ``lo = tf32(x - hi)``, and a
product is ``a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi`` summed in float32.
``split_tf32`` is that split, ``bottleneck_tf32_model`` the block in this
arithmetic in plain PyTorch (for tests; no path runs it), and
``pack_bottleneck`` lays the folded weights out in the order of the MMA
fragments, once per block on the host, and ``choose_tile`` picks a thread
block's output tile for an image size and batch.  The kernel splits each weight
fragment into hi and lo in registers with the same mask, because hi and lo
of all weights together (238 KB) do not fit one thread block's shared
memory beside the activations.  The 128-wide blocks' float32 weights alone
(215-231 KB) do not fit either: their instances keep w1, w3 and wp resident
and stream w2 through shared memory one tap at a time (``streams_w2``;
``smem_bytes`` and ``choose_tile`` know both layouts).
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

# one thread block's output tile holds at most 12 warps x 16 pixels, at most
# 16 wide
TILE_WARPS = 12
TILE_MAX_WIDTH = 16
NUM_SMS = 132                     # H100 SXM
MAX_SMEM = 227 * 1024             # bytes one thread block can use
# (Cin, Cmid, Cout, projects) the kernel is instantiated for: the 96- and
# 64-wide fly networks' blocks (every weight resident in shared memory), and
# the 128-wide h36m network's (the 3x3's weights streamed, ``streams_w2``)
INSTANCES = ((96, 48, 96, False), (48, 48, 96, True), (64, 32, 64, False), (32, 32, 64, True),
             (128, 64, 128, False), (64, 64, 128, True))
_TF32_MASK = -8192                # 0xffffe000 as int32: clears 13 mantissa bits


def bn_affine(scale, bias, mean, var, eps: float = BN_EPS):
    """BatchNorm at inference is x*s + t; return (s, t) as float32 numpy."""
    s = np.asarray(scale, np.float64) / np.sqrt(np.asarray(var, np.float64) + eps)
    t = np.asarray(bias, np.float64) - np.asarray(mean, np.float64) * s
    return s.astype(np.float32), t.astype(np.float32)


def fold_bottleneck(params: Dict, stats: Dict) -> Dict[str, torch.Tensor]:
    """Fold one block's batch norms; arrays as the JAX ``fold_bottleneck``.

    ``params``/``stats`` are one Bottleneck's numpy collections (bn1..bn3,
    conv1..conv3, optional proj).  Returns float32 CPU tensors: s1/t1
    (1, Cin); w1 (Cin, Cmid); w2 (9, Cmid, Cmid); w3 (Cmid, Cout); biases
    (1, C); wp (Cin, Cout) and bp (1, Cout) when the block projects.
    """
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
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def bottleneck_plain(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the block (matmuls + one F.conv2d), float32."""
    a1 = torch.relu(x * folded["s1"][0] + folded["t1"][0])
    a2 = torch.relu(a1 @ folded["w1"] + folded["b1"][0])
    cmid = folded["w2"].shape[1]
    w2 = folded["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)   # OIHW
    z2 = F.conv2d(a2.permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
    a3 = torch.relu(z2 + folded["b2"][0])
    z3 = a3 @ folded["w3"] + folded["b3"][0]
    if "wp" in folded:
        res = a1 @ folded["wp"] + folded["bp"][0]
    else:
        res = x
    return (z3 + res).contiguous()


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
        res = product(a1, folded["wp"], torch.matmul) + folded["bp"][0]
    else:
        res = x
    return (z3 + res).contiguous()


def _pack_fragments(w: np.ndarray, order: str) -> np.ndarray:
    """(K, N) -> flat (K/8, N/8, 32 lanes, 2): the B fragments of
    mma.m16n8k8, lane 4g+t holding column 8*nt+g of two rows of k step ks.
    The rows say which k the A fragment's slots t and t+4 stand for, which
    is free as long as A agrees: ``"mma"``: rows 8*ks + (t, t+4), A read out
    of a row-major tile; ``"paired"``: 8*ks + (2t, 2t+1), A an accumulator
    fragment reused; ``"lanes"``: t*K/4 + (2*ks, 2*ks+1), A the K/4
    neighbouring channels of a pixel that lane column t reads from x."""
    k, n = w.shape
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    step = np.arange(k // 8)[:, None, None]
    k0, k1 = {"mma": (8 * step + t, 8 * step + t + 4),
              "paired": (8 * step + 2 * t, 8 * step + 2 * t + 1),
              "lanes": (t * (k // 4) + 2 * step, t * (k // 4) + 2 * step + 1)}[order]
    cols = 8 * np.arange(n // 8)[None, :, None] + g[None, None, :]
    return np.stack([w[k0, cols], w[k1, cols]], axis=-1).reshape(-1)


def pack_bottleneck(folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's weight buffer of one block, a flat float32 CPU tensor:
    w1 ("lanes" k order), w2 (as (9*Cmid, Cmid), tap-major, "mma"), w3
    ("paired") and wp ("lanes") in fragment order, then s1, t1, b1, b2 and
    b3 (+ bp).  Every value is a folded float32 weight unchanged; the kernel
    splits hi/lo as it loads."""
    f = {k: v.detach().cpu().numpy() for k, v in folded.items() if k != "packed"}
    cmid = f["w1"].shape[1]
    parts = [_pack_fragments(f["w1"], "lanes"),
             _pack_fragments(f["w2"].reshape(9 * cmid, cmid), "mma"),
             _pack_fragments(f["w3"], "paired")]
    b3 = f["b3"][0]
    if "wp" in f:
        parts.append(_pack_fragments(f["wp"], "lanes"))
        b3 = b3 + f["bp"][0]
    parts += [f["s1"][0], f["t1"][0], f["b1"][0], f["b2"][0], b3]
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def add_packed(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``folded`` plus its ``"packed"`` weight buffer, which the kernel reads."""
    return {**folded, "packed": pack_bottleneck(folded)}


def packed_size(cin: int, cmid: int, cout: int, has_proj: bool) -> int:
    """Number of float32 values in a block's packed weight buffer."""
    return (cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout if has_proj else 0)
            + 2 * cin + 2 * cmid + cout)


def _smem(cin: int, cmid: int, cout: int, th: int, tw: int, has_proj: bool,
          stream: bool) -> int:
    hp = (th + 2) * (tw + 2)
    weights = packed_size(cin, cmid, cout, has_proj)
    if stream:
        weights += (2 - 9) * cmid * cmid           # a ring of two w2 taps instead of nine
    return 4 * (weights + 2 * hp * (cmid + 4))


def streams_w2(cin: int, cmid: int, cout: int, has_proj: bool) -> bool:
    """Whether the kernel streams the 3x3's weights through shared memory one
    tap at a time: where all the weights and the smallest tile (one row of
    16 pixels) do not fit, as for the 128-wide networks' blocks."""
    return _smem(cin, cmid, cout, 1, TILE_MAX_WIDTH, has_proj, False) > MAX_SMEM


def smem_bytes(cin: int, cmid: int, cout: int, th: int, tw: int, has_proj: bool) -> int:
    """Dynamic shared memory of one thread block: the packed weights (without
    w2 and with a ring of two w2 taps where ``streams_w2``) and two buffers of
    a2 on the (th+2) x (tw+2) halo tile at pitch Cmid+4."""
    return _smem(cin, cmid, cout, th, tw, has_proj, streams_w2(cin, cmid, cout, has_proj))


# Microseconds one thread block took for a tile of m 16-pixel MMA row tiles
# (index m; one warp each in the 3x3), 96->48->96 block, launches of many
# waves: NVIDIA H100 80GB HBM3 at 700 W, tile sweep with
# ``scripts/bench_torch_kernels.py`` at 56 x 64x128 (m = 1, 2, 7, 9 filled in
# between).  The steps at m = 5 and m = 9 are a second and a third warp on an
# SM's four schedulers.
_TILE_US = (None, 9.0, 9.7, 9.7, 11.0, 15.7, 16.8, 17.7, 18.6, 22.0, 23.6, 25.2, 26.1)
# The same for the streamed-w2 design, 128->64->128 and 64->64->128 (+proj)
# blocks: device time of the launch over its waves, tile sweep with
# ``scripts/bench_torch_kernels.py --tiles`` at the h36m shapes (8 x 192x192
# ... 6x6; m = 12 extrapolated), NVIDIA H100 80GB HBM3 at 700 W.
_TILE_US_STREAMED = (None, 18.0, 19.5, 20.5, 22.5, 31.0, 32.5, 34.0, 35.5, 47.0, 49.0, 50.5,
                     52.0)


@lru_cache(maxsize=None)
def choose_tile(n: int, h: int, w: int, cin: int, cmid: int, cout: int, has_proj: bool):
    """Output tile (rows, cols) of one thread block for an (n, h, w) batch:
    the one whose launch should take least time, waves of thread blocks over
    the SMs times the measured time of such a tile (the streamed design's
    own table where w2 streams), among those that fit shared memory.  Large images get 8x16 tiles; small images and batches
    fewer rows, until one wave covers the launch.  Raises ValueError if no
    tile fits."""
    tw = min(TILE_MAX_WIDTH, w)
    tile_us = _TILE_US_STREAMED if streams_w2(cin, cmid, cout, has_proj) else _TILE_US
    best = None
    for th in range(1, min(h, 16 * TILE_WARPS // tw) + 1):
        if smem_bytes(cin, cmid, cout, th, tw, has_proj) > MAX_SMEM:
            break
        waves = -(-n * -(-h // th) * -(-w // tw) // NUM_SMS)
        cost = waves * tile_us[-(-th * tw // 16)]
        if best is None or cost < best[0]:
            best = (cost, th)
    if best is None:
        raise ValueError(f"block too wide for one thread block's shared memory "
                         f"(Cin={cin}, Cmid={cmid}, Cout={cout})")
    return best[1], tw


def _shapes(x: torch.Tensor, folded: Dict[str, torch.Tensor]):
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
    for k, shape in want.items():
        if tuple(folded[k].shape) != shape:
            raise ValueError(f"folded[{k!r}] has shape {tuple(folded[k].shape)}, want {shape}")
    return cin, cmid, cout


@lru_cache(maxsize=None)
def _kernel():
    fn = _build.library("bottleneck").df3d_bottleneck
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bottleneck(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One folded bottleneck block, (N, H, W, Cin) -> (N, H, W, Cout) float32.

    On a CUDA tensor this launches ``csrc/bottleneck.cu`` (one launch, every
    intermediate on chip; ``folded`` must hold the ``"packed"`` buffer of
    ``add_packed``) or raises; on a CPU tensor it runs ``bottleneck_plain``.
    ``fused_bottleneck.launches`` counts launches.
    """
    cin, cmid, cout = _shapes(x, folded)
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not {x.device}")
    has_proj = "wp" in folded
    if "packed" not in folded:
        raise ValueError("folded lacks the kernel's weight buffer: pass add_packed(folded)")
    packed = folded["packed"]
    for name, t in (("x", x), ("folded['packed']", packed)):     # what the kernel reads
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if (cin, cmid, cout, has_proj) not in INSTANCES:
        raise ValueError(f"kernel has no instantiation for Cin={cin}, Cmid={cmid}, "
                         f"Cout={cout}, projection={has_proj}; it has {INSTANCES}")
    if packed.numel() != packed_size(cin, cmid, cout, has_proj):
        raise ValueError(f"folded['packed'] has {packed.numel()} values: not this block's")
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    th, tw = choose_tile(n, h, w, cin, cmid, cout, has_proj)
    rc = _kernel()(
        x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout,
        int(has_proj), th, tw, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "bottleneck kernel")
    fused_bottleneck.launches += 1
    return y


fused_bottleneck.launches = 0
