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
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from deepfly3d_torch.ops import _build

BN_EPS = 1e-5  # flax.linen.BatchNorm default

# output tile of one thread block (rows, cols), clamped to the image
TILE = (8, 16)
# the kernel's register tile is 8 channels wide
_CHANNEL_MULTIPLE = 8
_MAX_SMEM = 227 * 1024


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


def _lib():
    lib = _build.library("bottleneck")
    lib.df3d_bottleneck.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.df3d_bottleneck.restype = ctypes.c_int
    lib.df3d_bottleneck_smem.argtypes = [ctypes.c_int] * 5
    lib.df3d_bottleneck_smem.restype = ctypes.c_size_t
    return lib


def fused_bottleneck(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One folded bottleneck block, (N, H, W, Cin) -> (N, H, W, Cout) float32.

    On a CUDA tensor this launches ``csrc/bottleneck.cu`` (one launch, every
    intermediate on chip) or raises; on a CPU tensor it runs
    ``bottleneck_plain``.  ``fused_bottleneck.launches`` counts launches.
    """
    cin, cmid, cout = _shapes(x, folded)
    if x.device.type == "cpu":
        return bottleneck_plain(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not {x.device}")
    has_proj = "wp" in folded
    for name, t in [("x", x), *folded.items()]:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if cmid % _CHANNEL_MULTIPLE or cout % _CHANNEL_MULTIPLE:
        raise ValueError(f"kernel needs Cmid and Cout multiples of {_CHANNEL_MULTIPLE}")
    n, h, w, _ = x.shape
    th, tw = min(TILE[0], h), min(TILE[1], w)
    lib = _lib()
    if lib.df3d_bottleneck_smem(cin, cmid, th, tw, int(has_proj)) > _MAX_SMEM:
        raise ValueError(f"block too wide for one thread block's shared memory "
                         f"(Cin={cin}, Cmid={cmid})")
    y = torch.empty((n, h, w, cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    f = folded
    rc = lib.df3d_bottleneck(
        x.data_ptr(), f["s1"].data_ptr(), f["t1"].data_ptr(), f["w1"].data_ptr(),
        f["b1"].data_ptr(), f["w2"].data_ptr(), f["b2"].data_ptr(),
        f["w3"].data_ptr(), f["b3"].data_ptr(),
        f["wp"].data_ptr() if has_proj else None,
        f["bp"].data_ptr() if has_proj else None,
        y.data_ptr(), n, h, w, cin, cmid, cout, th, tw,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "bottleneck kernel")
    fused_bottleneck.launches += 1
    return y


fused_bottleneck.launches = 0
