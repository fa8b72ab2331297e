"""The stacked hourglass of Newell et al. (arXiv:1603.06937), plain PyTorch.

The network as its equations read, in NCHW float32: every batch norm in
eval mode from its four vectors (nothing folded), pre-activation bottleneck
blocks (bn1, relu, 1x1, bn2, relu, 3x3, bn3, relu, 1x1, plus the skip, or
its 1x1 projection where the widths differ), a recursive hourglass of
nearest-neighbour upsampling and 2x2 max-pools, and between stacks the
re-injection ``y + fc_(f) + score_(score)``.  The conv stem: 7x7/2 conv, bn,
relu, a block, 2x2 max-pool, two blocks.

The weights come in one of two layouts, read through a ``Layout``: a
checkpoint of this repository (flax names, HWIO kernels; ``FlaxLayout``) or
a state dict of the canonical torch stacked hourglass (``TorchLayout``; its
level list innermost-first).  Both give a block's convolutions as OIHW
tensors and its batch norms as (scale, bias, mean, var).  Nothing here reads
the program under test.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


class Layout:
    """Named access to the weights.  Logical names: ``stem_conv``,
    ``stem_bn``, ``stem_res{1,2,3}``, ``hg{s}.{skip,down,up}{d}`` (d the
    recursion depth, the top level = depth), ``hg{s}.innermost1``,
    ``feat_res{s}``, ``feat_conv{s}``, ``feat_bn{s}``, ``score{s}``,
    ``remap_feat{s}``, ``remap_score{s}``.  ``block`` and ``head`` map them
    to the layout's own names, ``sub`` names a part of a block (``bn1``,
    ``conv1``, ..., ``proj``), ``conv`` gives (OIHW weight, bias or None)
    and ``bn`` (scale, bias, mean, var)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.t = tensors


class FlaxLayout(Layout):
    """``params/<module>/kernel`` (HWIO), ``params/<bn>/{scale,bias}``,
    ``batch_stats/<bn>/{mean,var}``; blocks ``hg{s}/skip_d{d}_0`` etc."""

    def conv(self, name):
        w = self.t[f"params/{name}/kernel"].permute(3, 2, 0, 1).contiguous()
        return w, self.t.get(f"params/{name}/bias")

    def bn(self, name):
        return (self.t[f"params/{name}/scale"], self.t[f"params/{name}/bias"],
                self.t[f"batch_stats/{name}/mean"], self.t[f"batch_stats/{name}/var"])

    def block(self, name):
        s, kind, d = _parse(name)
        if s is None:
            return name
        return f"hg{s}/{kind}_d{d}_0" if kind != "innermost" else f"hg{s}/innermost_0"

    def sub(self, block, part):
        return {"proj": f"{block}/proj"}.get(part, f"{block}/{part}")

    def has_proj(self, block):
        return f"params/{block}/proj/kernel" in self.t

    def head(self, name):
        return name


class TorchLayout(Layout):
    """The canonical torch names: ``conv1``/``bn1``, ``layer{1,2,3}.0``,
    ``hg.{s}.hg.{level}.{slot}.0`` (level = recursion depth - 1; slots skip,
    down, up, innermost), ``res.{s}.0``, ``fc.{s}.0``/``fc.{s}.1``,
    ``score.{s}``, ``fc_.{s}``, ``score_.{s}``; kernels OIHW."""

    _HEADS = {"stem_conv": "conv1", "stem_bn": "bn1"}

    def conv(self, name):
        return self.t[f"{name}.weight"], self.t.get(f"{name}.bias")

    def bn(self, name):
        return (self.t[f"{name}.weight"], self.t[f"{name}.bias"],
                self.t[f"{name}.running_mean"], self.t[f"{name}.running_var"])

    def block(self, name):
        if name.startswith("stem_res"):
            return f"layer{name[-1]}.0"
        if name.startswith("feat_res"):
            return f"res.{name[len('feat_res'):]}.0"
        s, kind, d = _parse(name)
        slot = {"skip": 0, "down": 1, "up": 2, "innermost": 3}[kind]
        return f"hg.{s}.hg.{d - 1}.{slot}.0"

    def sub(self, block, part):
        return f"{block}.downsample.0" if part == "proj" else f"{block}.{part}"

    def has_proj(self, block):
        return f"{block}.downsample.0.weight" in self.t

    def head(self, name):
        if name in self._HEADS:
            return self._HEADS[name]
        for flax, torch_name in (("feat_conv", "fc.{}.0"), ("feat_bn", "fc.{}.1"),
                                 ("remap_feat", "fc_.{}"), ("remap_score", "score_.{}"),
                                 ("score", "score.{}")):
            if name.startswith(flax):
                return torch_name.format(name[len(flax):])
        raise KeyError(name)


def _parse(name: str):
    """``hg{s}.{kind}{d}`` -> (s, kind, d); other names -> (None, None, None)."""
    if not name.startswith("hg"):
        return None, None, None
    stack, rest = name[2:].split(".")
    kind = rest.rstrip("0123456789")
    return int(stack), kind, int(rest[len(kind):] or 1)


def batch_norm(x: torch.Tensor, p) -> torch.Tensor:
    scale, bias, mean, var = p
    inv = scale / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]


def conv(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    w, b = p
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


class Hourglass:
    """``forward(x NCHW float32) -> the last stack's heatmaps (N, K, h, w)``."""

    def __init__(self, layout: Layout, spec: dict, proj_from_raw: bool):
        if spec["stem"] != "conv" or spec["num_blocks"] != 1:
            raise ValueError("the reference runs the conv stem with one block per level")
        self.L, self.spec, self.raw = layout, spec, proj_from_raw

    def block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        L = self.L
        b = L.block(name)
        y = torch.relu(batch_norm(x, L.bn(L.sub(b, "bn1"))))
        skip = x
        if L.has_proj(b):
            skip = conv(x if self.raw else y, L.conv(L.sub(b, "proj")))
        y = torch.relu(batch_norm(conv(y, L.conv(L.sub(b, "conv1"))), L.bn(L.sub(b, "bn2"))))
        y = torch.relu(batch_norm(conv(y, L.conv(L.sub(b, "conv2"))), L.bn(L.sub(b, "bn3"))))
        return conv(y, L.conv(L.sub(b, "conv3"))) + skip

    def level(self, x: torch.Tensor, s: int, d: int) -> torch.Tensor:
        up = self.block(x, f"hg{s}.skip{d}")
        low = self.block(F.max_pool2d(x, 2, 2), f"hg{s}.down{d}")
        low = self.level(low, s, d - 1) if d > 1 else self.block(low, f"hg{s}.innermost1")
        low = self.block(low, f"hg{s}.up{d}")
        return up + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L, S = self.L, self.spec["num_stacks"]
        y = torch.relu(batch_norm(conv(x, L.conv(L.head("stem_conv")), stride=2),
                                  L.bn(L.head("stem_bn"))))
        y = F.max_pool2d(self.block(y, "stem_res1"), 2, 2)
        y = self.block(self.block(y, "stem_res2"), "stem_res3")
        for s in range(S):
            f = self.block(self.level(y, s, self.spec["depth"]), f"feat_res{s}")
            f = torch.relu(batch_norm(conv(f, L.conv(L.head(f"feat_conv{s}"))),
                                      L.bn(L.head(f"feat_bn{s}"))))
            score = conv(f, L.conv(L.head(f"score{s}")))
            if s < S - 1:
                y = y + conv(f, L.conv(L.head(f"remap_feat{s}"))) \
                    + conv(score, L.conv(L.head(f"remap_score{s}")))
        return score
