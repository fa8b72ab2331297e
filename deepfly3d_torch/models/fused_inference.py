"""Folded-weight forward of the stacked hourglass (inference only).

Counterpart of ``deepfly3d_tpu/models/fused_inference.py``, held to the
flax graph ``HourglassNet.apply(train=False)`` (``models/hourglass.py``)
for every shipped spec.  Every batch norm is folded into its neighbouring
convolution once on the host (``fold_hourglass``, the weight carry-over
from a JAX checkpoint), and the forward (``FoldedHourglass``) runs

* each residual block (31 at the 2-stack depth-4 conv-stem spec, 16 at the
  1-stack patch-stem specs) in one launch of the bottleneck kernel
  (``ops/bottleneck.fused_bottleneck``),
* each hourglass level merge in the upsample-add kernel
  (``ops/kernels.upsample2x_add``),

and leaves the rest to plain PyTorch in full float32, as the JAX package
leaves it to XLA:

* the stem: ``conv`` (7x7/2 convolution, residual, 2x2 max-pool),
  ``patch16`` (16x16/8 convolution, padding 4), ``patch8`` (8x8/4,
  padding 2) or ``patchify`` (4x4 space-to-depth and a 1x1 embedding),
  each followed by the folded batch norm and a ReLU;
* the max-pools and the 1x1 feature heads;
* the score head: a k x k convolution (``score_ksize``, odd k, SAME zero
  padding) to ``num_classes * u * u`` channels and, for ``head_upsample``
  u > 1, the depth-to-space to (H*u, W*u, num_classes) in the JAX order
  (output cell (h*u+dy, w*u+dx) reads channel block dy*u+dx); the
  re-injection between stacks reads the pre-shuffle channels.

``hp_scope`` / ``hp_precision`` pin the TPU's matmul passes to "highest"
from some layer on.  The port runs every convolution and matmul in full
float32 with TF32 off (``utils/devices.full_f32``), which is what
"highest" asks for, so every scope maps to the port's one float32 policy
and the field is accepted and otherwise ignored.  ``proj_from_raw`` (the
skip projection of width-changing blocks reads the raw block input, the
convention of checkpoints converted from torch) is folded into the blocks
and runs in the bottleneck kernel's raw-projection instances; the JAX fold
ignores it (ROADMAP Queue 3), so the port is held to ``HourglassNet.apply``
there.  A compute dtype other than float32 raises.

Tensors are NHWC throughout; the output is the JAX contract
(num_stacks, N, H', W', K) with H' = H/4 for every shipped spec.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops.bottleneck import (add_packed, bn_affine, fold_bottleneck,
                                            fused_bottleneck)
from deepfly3d_torch.ops.kernels import upsample2x_add

# (kernel, stride, padding) of the strided patch embeddings
_PATCH_CONV = {"patch16": (16, 8, 4), "patch8": (8, 4, 2)}
STEMS = ("conv", "patchify", "patch8", "patch16")


def check_foldable(spec: HourglassSpec) -> None:
    """Raise ValueError for a spec the folded forward does not compute.

    The JAX ``fold_hourglass`` ignores unknown fields and would silently
    compute another function; the port refuses them instead.
    """
    problems = []
    if spec.stem not in STEMS:
        problems.append(f"stem={spec.stem!r} (one of {STEMS})")
    if spec.score_ksize < 1 or spec.score_ksize % 2 == 0:
        problems.append(f"score_ksize={spec.score_ksize} (odd k only: SAME padding)")
    if spec.head_upsample < 1:
        problems.append(f"head_upsample={spec.head_upsample} (>= 1)")
    if spec.compute_dtype != "float32":
        problems.append(f"compute_dtype={spec.compute_dtype!r} (only float32)")
    if problems:
        raise ValueError("fold_hourglass does not cover " + ", ".join(problems))


def _fold_conv_bn(conv: Dict, bn_params: Dict, bn_stats: Dict):
    """conv -> bn folds into the conv: W' = W*s (out channels), b' = b*s + t."""
    s, t = bn_affine(**bn_params, **bn_stats)
    kernel = np.asarray(conv["kernel"], np.float64)
    w = kernel * s.reshape((1,) * (kernel.ndim - 1) + (-1,))
    b = np.asarray(conv["bias"], np.float64) * s + t
    return _f32(w), _f32(b)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))    # a writable copy


def block_names(spec: HourglassSpec) -> List[str]:
    """Names of the residual blocks in forward order."""
    names = ["stem_res1"] if spec.stem == "conv" else []
    names += ["stem_res2", "stem_res3"]

    def walk(prefix: str, d: int):
        for kind in ("skip", "down"):
            names.extend(f"{prefix}/{kind}_d{d}_{i}" for i in range(spec.num_blocks))
        if d > 1:
            walk(prefix, d - 1)
        else:
            names.extend(f"{prefix}/innermost_{i}" for i in range(spec.num_blocks))
        names.extend(f"{prefix}/up_d{d}_{i}" for i in range(spec.num_blocks))

    for s in range(spec.num_stacks):
        walk(f"hg{s}", spec.depth)
        names.append(f"feat_res{s}")
    return names


def fold_hourglass(variables: Dict, spec: HourglassSpec) -> Dict[str, Any]:
    """One-time host-side fold of a checkpoint's numpy ``variables``.

    Returns float32 CPU tensors laid out as the JAX ``fold_hourglass``:
    ``stem_w`` (HWIO: (7, 7, 3, F/2) for the conv stem, (k, k, 3, F) for
    ``patch16``/``patch8``, (1, 1, 48, F) for ``patchify``) and ``stem_b``;
    ``blocks[name]`` as ``fold_bottleneck``; ``stacks[i]`` with ``feat_w``
    (F, F), ``feat_b``, ``score_w`` ((F, K*u*u) for a 1x1 score head, HWIO
    (k, k, F, K*u*u) otherwise), ``score_b`` and, between stacks,
    ``remap_feat_*`` and ``remap_score_*``.  Raises ValueError for a spec
    it does not cover.
    """
    check_foldable(spec)
    params = variables["params"]
    stats = variables["batch_stats"]

    def node(tree: Dict, name: str) -> Dict:
        for part in name.split("/"):
            tree = tree[part]
        return tree

    folded: Dict[str, Any] = {"blocks": {}}
    stem = "stem_conv" if spec.stem == "conv" else "patch_embed"
    folded["stem_w"], folded["stem_b"] = _fold_conv_bn(
        params[stem], params["stem_bn"], stats["stem_bn"]
    )
    for name in block_names(spec):
        folded["blocks"][name] = fold_bottleneck(node(params, name), node(stats, name),
                                                 spec.proj_from_raw)

    folded["stacks"] = []
    for s in range(spec.num_stacks):
        stack: Dict[str, torch.Tensor] = {}
        fw, stack["feat_b"] = _fold_conv_bn(
            params[f"feat_conv{s}"], params[f"feat_bn{s}"], stats[f"feat_bn{s}"]
        )
        stack["feat_w"] = fw[0, 0].contiguous()
        score = np.asarray(params[f"score{s}"]["kernel"])
        stack["score_w"] = _f32(score[0, 0] if spec.score_ksize == 1 else score)
        stack["score_b"] = _f32(params[f"score{s}"]["bias"])
        if s < spec.num_stacks - 1:
            for kind in ("feat", "score"):
                p = params[f"remap_{kind}{s}"]
                stack[f"remap_{kind}_w"] = _f32(np.asarray(p["kernel"])[0, 0])
                stack[f"remap_{kind}_b"] = _f32(p["bias"])
        folded["stacks"].append(stack)
    return folded


class _Tensors(nn.Module):
    """A named group of buffers (one block's or one stack's folded arrays)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v.contiguous())

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._buffers)      # this module's own buffers; it has no children


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/4, W/4, 16C), channel (dy*4 + dx)*C + c, as the JAX patchify."""
    n, h, w, c = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"the patchify stem needs H and W multiples of 4, got {(h, w)}")
    y = x.reshape(n, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // 4, w // 4, 16 * c)


def depth_to_space(raw: torch.Tensor, u: int) -> torch.Tensor:
    """(N, H, W, u*u*K) -> (N, H*u, W*u, K); cell (h*u+dy, w*u+dx) reads block dy*u+dx."""
    n, h, w, c = raw.shape
    k = c // (u * u)
    return (raw.reshape(n, h, w, u, u, k).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h * u, w * u, k))


def _dot1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def _conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, b: torch.Tensor,
               stride: int, padding: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1) + b


class FoldedHourglass(nn.Module):
    """Stacked-hourglass forward over folded weights; NHWC float32.

    ``forward`` maps (N, H, W, 3) to (num_stacks, N, H/4, W/4, K) — the
    output contract of ``HourglassNet.apply(..., train=False)``.  Blocks
    run through ``block_fn`` (``fused_bottleneck``) and level merges through
    ``merge_fn`` (``upsample2x_add``), which launch the CUDA kernels on a
    card; ``pipeline.plain_twin`` swaps in their plain versions.
    """

    def __init__(self, folded: Dict[str, Any], spec: HourglassSpec):
        super().__init__()
        check_foldable(spec)
        self.spec = spec
        stem_w = folded["stem_w"]
        if spec.stem == "patchify":
            stem_w = stem_w[0, 0]                       # (48, F) matmul
        else:
            stem_w = stem_w.permute(3, 2, 0, 1)         # HWIO -> OIHW for F.conv2d
        self.register_buffer("stem_w", stem_w.contiguous())
        self.register_buffer("stem_b", folded["stem_b"].contiguous())
        # ModuleDict keys may not hold '.', block names hold '/' only; each
        # block carries its weights once more in the kernel's fragment order
        self.blocks = nn.ModuleDict(
            {name: _Tensors(add_packed(t)) for name, t in folded["blocks"].items()}
        )
        stacks = []
        for t in folded["stacks"]:
            t = dict(t)
            if spec.score_ksize > 1:
                t["score_w"] = t["score_w"].permute(3, 2, 0, 1)
            stacks.append(_Tensors(t))
        self.stacks = nn.ModuleList(stacks)
        self.block_fn = fused_bottleneck
        self.merge_fn = upsample2x_add

    def block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.block_fn(x, self.blocks[name].as_dict())

    def merge(self, inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.merge_fn(inner, skip)

    def _level(self, y: torch.Tensor, prefix: str, d: int) -> torch.Tensor:
        nb = self.spec.num_blocks
        skip = y
        for i in range(nb):
            skip = self.block(f"{prefix}/skip_d{d}_{i}", skip)
        down = maxpool2(y)
        for i in range(nb):
            down = self.block(f"{prefix}/down_d{d}_{i}", down)
        if d > 1:
            inner = self._level(down, prefix, d - 1)
        else:
            inner = down
            for i in range(nb):
                inner = self.block(f"{prefix}/innermost_{i}", inner)
        for i in range(nb):
            inner = self.block(f"{prefix}/up_d{d}_{i}", inner)
        return self.merge(inner, skip)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        stem = self.spec.stem
        if stem == "patchify":
            y = _dot1x1(space_to_depth4(x), self.stem_w, self.stem_b)
        elif stem == "conv":
            y = _conv_nhwc(x, self.stem_w, self.stem_b, stride=2, padding=3)
        else:
            _, stride, padding = _PATCH_CONV[stem]
            y = _conv_nhwc(x, self.stem_w, self.stem_b, stride=stride, padding=padding)
        y = torch.relu(y).contiguous()
        if stem == "conv":
            y = maxpool2(self.block("stem_res1", y))
        y = self.block("stem_res2", y)
        return self.block("stem_res3", y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        y = self._stem(x.float())
        k, u = spec.score_ksize, spec.head_upsample
        outputs = []
        for s in range(spec.num_stacks):
            stack = self.stacks[s]
            hg = self._level(y, f"hg{s}", spec.depth)
            f = self.block(f"feat_res{s}", hg)
            f = torch.relu(_dot1x1(f, stack.feat_w, stack.feat_b))
            if k == 1:
                raw = _dot1x1(f, stack.score_w, stack.score_b)
            else:
                raw = _conv_nhwc(f, stack.score_w, stack.score_b, stride=1, padding=k // 2)
            outputs.append(depth_to_space(raw, u) if u > 1 else raw)
            if s < spec.num_stacks - 1:
                y = (
                    y
                    + _dot1x1(f, stack.remap_feat_w, stack.remap_feat_b)
                    + _dot1x1(raw, stack.remap_score_w, stack.remap_score_b)
                ).contiguous()
        return torch.stack(outputs)
