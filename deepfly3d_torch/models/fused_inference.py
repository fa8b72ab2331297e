"""Folded-weight forward of the stacked hourglass (inference only).

Counterpart of ``deepfly3d_tpu/models/fused_inference.py``.  Every batch
norm is folded into its neighbouring convolution once on the host
(``fold_hourglass``, the weight carry-over from a JAX checkpoint), and the
forward (``FoldedHourglass``) runs

* each of the residual blocks (31 at the shipped 2-stack depth-4 spec) in
  one launch of the bottleneck kernel (``ops/bottleneck.fused_bottleneck``),
* each hourglass level merge in the upsample-add kernel
  (``ops/kernels.upsample2x_add``),

and leaves the stem 7x7/2 convolution, the max-pools and the 1x1 heads to
plain PyTorch in full float32, as the JAX package leaves them to XLA.
Tensors are NHWC throughout; the output is the JAX contract
(num_stacks, N, H/4, W/4, K).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops.bottleneck import bn_affine, fold_bottleneck, fused_bottleneck
from deepfly3d_torch.ops.kernels import upsample2x_add


def check_foldable(spec: HourglassSpec) -> None:
    """Raise ValueError for a spec the folded forward does not compute.

    The JAX ``fold_hourglass`` ignores these fields and would silently
    compute another function; the port refuses them instead.
    """
    problems = []
    if spec.stem != "conv":
        problems.append(f"stem={spec.stem!r} (only 'conv')")
    if spec.score_ksize != 1:
        problems.append(f"score_ksize={spec.score_ksize} (only 1)")
    if spec.head_upsample != 1:
        problems.append(f"head_upsample={spec.head_upsample} (only 1)")
    if spec.hp_scope is not None:
        problems.append(f"hp_scope={spec.hp_scope!r} (only None)")
    if spec.proj_from_raw:
        problems.append("proj_from_raw=True (only False)")
    if spec.compute_dtype != "float32" or spec.preprocess_dtype != "float32":
        problems.append("a compute or preprocess dtype other than float32")
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
    names = ["stem_res1", "stem_res2", "stem_res3"]

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
    ``stem_w`` (7, 7, 3, F/2) HWIO, ``stem_b``; ``blocks[name]`` as
    ``fold_bottleneck``; ``stacks[i]`` with ``feat_w`` (F, F), ``feat_b``,
    ``score_w`` (F, K), ``score_b`` and, between stacks, ``remap_feat_*`` and
    ``remap_score_*``.  Raises ValueError for a spec it does not cover.
    """
    check_foldable(spec)
    params = variables["params"]
    stats = variables["batch_stats"]

    def node(tree: Dict, name: str) -> Dict:
        for part in name.split("/"):
            tree = tree[part]
        return tree

    folded: Dict[str, Any] = {"blocks": {}}
    folded["stem_w"], folded["stem_b"] = _fold_conv_bn(
        params["stem_conv"], params["stem_bn"], stats["stem_bn"]
    )
    for name in block_names(spec):
        folded["blocks"][name] = fold_bottleneck(node(params, name), node(stats, name))

    folded["stacks"] = []
    for s in range(spec.num_stacks):
        stack: Dict[str, torch.Tensor] = {}
        fw, stack["feat_b"] = _fold_conv_bn(
            params[f"feat_conv{s}"], params[f"feat_bn{s}"], stats[f"feat_bn{s}"]
        )
        stack["feat_w"] = fw[0, 0].contiguous()
        stack["score_w"] = _f32(np.asarray(params[f"score{s}"]["kernel"])[0, 0])
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
        return dict(self.named_buffers())


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _dot1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w + b


class FoldedHourglass(nn.Module):
    """Stacked-hourglass forward over folded weights; NHWC float32.

    ``forward`` maps (N, H, W, 3) to (num_stacks, N, H/4, W/4, K) — the
    output contract of ``HourglassNet.apply(..., train=False)`` and of the
    JAX ``fused_apply``.  Blocks run through ``block`` and level merges
    through ``merge``, which launch the CUDA kernels on a card.
    """

    def __init__(self, folded: Dict[str, Any], spec: HourglassSpec):
        super().__init__()
        check_foldable(spec)
        self.spec = spec
        # HWIO -> OIHW for F.conv2d
        self.register_buffer("stem_w", folded["stem_w"].permute(3, 2, 0, 1).contiguous())
        self.register_buffer("stem_b", folded["stem_b"].contiguous())
        # ModuleDict keys may not hold '.', block names hold '/' only
        self.blocks = nn.ModuleDict(
            {name: _Tensors(t) for name, t in folded["blocks"].items()}
        )
        self.stacks = nn.ModuleList(_Tensors(t) for t in folded["stacks"])

    def block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return fused_bottleneck(x, self.blocks[name].as_dict())

    def merge(self, inner: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return upsample2x_add(inner, skip)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = F.conv2d(x.permute(0, 3, 1, 2), self.stem_w, stride=2, padding=3)
        y = torch.relu(y.permute(0, 2, 3, 1) + self.stem_b).contiguous()
        y = self.block("stem_res1", y)
        y = maxpool2(y)
        y = self.block("stem_res2", y)
        y = self.block("stem_res3", y)

        outputs = []
        for s in range(self.spec.num_stacks):
            stack = self.stacks[s]
            hg = self._level(y, f"hg{s}", self.spec.depth)
            f = self.block(f"feat_res{s}", hg)
            f = torch.relu(_dot1x1(f, stack.feat_w, stack.feat_b))
            score = _dot1x1(f, stack.score_w, stack.score_b)
            outputs.append(score)
            if s < self.spec.num_stacks - 1:
                y = (
                    y
                    + _dot1x1(f, stack.remap_feat_w, stack.remap_feat_b)
                    + _dot1x1(score, stack.remap_score_w, stack.remap_score_b)
                ).contiguous()
        return torch.stack(outputs)
