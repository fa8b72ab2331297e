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
* the ``conv`` stem's 7x7/2 convolution with its folded batch norm and ReLU
  in the stem kernel (``ops/kernels.stem_conv``),
* each stack's head chain in the head kernel (``ops/kernels.stack_heads``):
  the 1x1 feature head and its ReLU, the 1x1 score head and, between stacks,
  both remaps and the two adds of the re-injection, in a float32 net of a
  width in ``HEAD_WIDTHS`` with a 1x1 score head, no upsampling and at most
  ``HEAD_CLASSES`` classes (the 96-wide fly nets); each stack writes its
  heatmaps into its slice of the one output tensor,

and leaves the rest to plain PyTorch in full float32, as the JAX package
leaves it to XLA:

* the rest of the stem: ``conv``'s residual and 2x2 max-pool, or
  ``patch16`` (16x16/8 convolution, padding 4), ``patch8`` (8x8/4,
  padding 2) or ``patchify`` (4x4 space-to-depth and a 1x1 embedding),
  each followed by the folded batch norm and a ReLU;
* the max-pools, and the head chains of every other net;
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
and runs in the bottleneck kernel's raw projection (at the converter's
default 256 features, in its general instance); the JAX fold
ignores it (ROADMAP Queue 3), so the port is held to ``HourglassNet.apply``
there.

``compute_dtype="bfloat16"`` is the JAX ``fold_hourglass(..., dtype=
jnp.bfloat16)`` with ``fused_apply``: tensors between layers are bfloat16,
every product has bfloat16 operands and float32 sums (computed here as
float32 products of bf16-valued tensors), and each layer rounds to
bfloat16 where JAX casts:

* the input is rounded at the start (a float32 preprocess), or arrives in
  bfloat16 (``preprocess_dtype="bfloat16"``);
* the stem is ``bf16(relu(conv(x, w) + b))``, the blocks those of
  ``ops/bottleneck.py``, the max-pools exact, the level merge
  ``bf16(skip + up)``, the feature head ``bf16(relu(f @ feat_w + feat_b))``;
* the score head reads ``f`` in float32 with float32 weights, so the
  heatmaps are float32 in both dtypes;
* the re-injection is ``bf16(bf16(y + bf16(f @ remap_feat_w + b)) +
  bf16(bf16(raw) @ remap_score_w + b))``;
* every folded weight is rounded to bfloat16 once, and so are the two remap
  biases (the JAX fold casts them to the dtype); the stem, feature-head,
  score and block biases and the score weights stay float32.

JAX's fold covers only the conv stem with a 1x1 score head; the patch stems
and the k x k score heads follow the same rule here, and are held to the
flax graph at ``compute_dtype=bfloat16`` (``tests/test_torch_bf16.py``).
``hp_scope`` changes nothing at bfloat16 either: its operands are bf16
values, and the score head is float32 in both packages.  A float32 net
whose spec has ``preprocess_dtype="bfloat16"`` takes the bfloat16 frames
upcast.  Any other dtype name raises.

Tensors are NHWC throughout; the output is the JAX contract
(num_stacks, N, H', W', K) with H' = H/4 for every shipped spec.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.ops import bottleneck as bn_ops
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.ops.bottleneck import (add_packed, bn_affine, fold_bottleneck,
                                            fused_bottleneck)
from deepfly3d_torch.ops.kernels import (HEAD_CLASSES, HEAD_WIDTHS, conv_nhwc, dot1x1,
                                         pack_heads, pack_stem, stack_heads, stem_conv,
                                         upsample2x_add)

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
    if spec.compute_dtype not in bn_ops.DTYPES:
        problems.append(f"compute_dtype={spec.compute_dtype!r} (one of {bn_ops.DTYPES})")
    if spec.preprocess_dtype not in image_ops.PREPROCESS_DTYPES:
        problems.append(f"preprocess_dtype={spec.preprocess_dtype!r} "
                        f"(one of {image_ops.PREPROCESS_DTYPES})")
    if problems:
        raise ValueError("fold_hourglass does not cover " + ", ".join(problems))


def _fold_conv_bn(conv: Dict, bn_params: Dict, bn_stats: Dict, dtype: torch.dtype):
    """conv -> bn folds into the conv: W' = W*s (out channels), b' = b*s + t;
    W' in ``dtype``, b' float32."""
    s, t = bn_affine(**bn_params, **bn_stats)
    kernel = np.asarray(conv["kernel"], np.float64)
    w = kernel * s.reshape((1,) * (kernel.ndim - 1) + (-1,))
    b = np.asarray(conv["bias"], np.float64) * s + t
    return _cast(w, dtype), _f32(b)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))    # a writable copy


def _cast(a, dtype: torch.dtype) -> torch.Tensor:
    """float64 or float32 numpy -> ``dtype``, rounded once (``jnp.asarray(a, dtype)``)."""
    if dtype == torch.float32:
        return _f32(a)
    return torch.from_numpy(np.array(a)).to(dtype)


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

    Returns CPU tensors laid out as the JAX ``fold_hourglass`` at the
    spec's ``compute_dtype`` (weights in it, biases float32; module
    docstring):
    ``stem_w`` (HWIO: (7, 7, 3, F/2) for the conv stem, (k, k, 3, F) for
    ``patch16``/``patch8``, (1, 1, 48, F) for ``patchify``) and ``stem_b``;
    ``blocks[name]`` as ``fold_bottleneck``; ``stacks[i]`` with ``feat_w``
    (F, F), ``feat_b``, ``score_w`` ((F, K*u*u) for a 1x1 score head, HWIO
    (k, k, F, K*u*u) otherwise), ``score_b`` and, between stacks,
    ``remap_feat_*`` and ``remap_score_*``.  Raises ValueError for a spec
    it does not cover.
    """
    check_foldable(spec)
    dtype = bn_ops.check_dtype(spec.compute_dtype)
    params = variables["params"]
    stats = variables["batch_stats"]

    def node(tree: Dict, name: str) -> Dict:
        for part in name.split("/"):
            tree = tree[part]
        return tree

    folded: Dict[str, Any] = {"blocks": {}}
    stem = "stem_conv" if spec.stem == "conv" else "patch_embed"
    folded["stem_w"], folded["stem_b"] = _fold_conv_bn(
        params[stem], params["stem_bn"], stats["stem_bn"], dtype
    )
    for name in block_names(spec):
        folded["blocks"][name] = fold_bottleneck(node(params, name), node(stats, name),
                                                 spec.proj_from_raw, spec.compute_dtype)

    folded["stacks"] = []
    for s in range(spec.num_stacks):
        stack: Dict[str, torch.Tensor] = {}
        fw, stack["feat_b"] = _fold_conv_bn(
            params[f"feat_conv{s}"], params[f"feat_bn{s}"], stats[f"feat_bn{s}"], dtype
        )
        stack["feat_w"] = fw[0, 0].contiguous()
        score = np.asarray(params[f"score{s}"]["kernel"])
        stack["score_w"] = _f32(score[0, 0] if spec.score_ksize == 1 else score)
        stack["score_b"] = _f32(params[f"score{s}"]["bias"])
        if s < spec.num_stacks - 1:
            for kind in ("feat", "score"):
                p = params[f"remap_{kind}{s}"]
                stack[f"remap_{kind}_w"] = _cast(np.asarray(p["kernel"])[0, 0], dtype)
                stack[f"remap_{kind}_b"] = _cast(p["bias"], dtype)
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


class FoldedHourglass(nn.Module):
    """Stacked-hourglass forward over folded weights; NHWC, float32 or
    bfloat16 between layers (the spec's ``compute_dtype``).

    ``forward`` maps (N, H, W, 3) to float32 (num_stacks, N, H/4, W/4, K) —
    the output contract of ``HourglassNet.apply(..., train=False)``.  Blocks
    run through ``block_fn`` (``fused_bottleneck``), level merges through
    ``merge_fn`` (``upsample2x_add``) and the conv stem's convolution, bias and
    ReLU through ``stem_fn`` (``stem_conv``, float32 products in both dtypes,
    on the weights packed once as ``stem_packed``) and, where ``heads_fused``,
    each stack's head chain through ``head_fn`` (``stack_heads``, on each
    stack's ``head_packed`` and ``head_biases``),
    which launch the CUDA kernels (the bfloat16 instances in a bfloat16 net)
    on a card;
    ``pipeline.plain_twin`` swaps in their plain versions.  The glue's weights
    are kept as float32 tensors (bf16 values in a bfloat16 net), the operands
    of its float32 products.
    """

    def __init__(self, folded: Dict[str, Any], spec: HourglassSpec):
        super().__init__()
        check_foldable(spec)
        self.spec = spec
        self.bf16 = spec.compute_dtype == "bfloat16"
        stem_w = folded["stem_w"].float()
        if spec.stem == "patchify":
            stem_w = stem_w[0, 0]                       # (48, F) matmul
        else:
            stem_w = stem_w.permute(3, 2, 0, 1)         # HWIO -> OIHW for F.conv2d
        self.register_buffer("stem_w", stem_w.contiguous())
        self.register_buffer("stem_b", folded["stem_b"].contiguous())
        if spec.stem == "conv":
            self.register_buffer("stem_packed", pack_stem(stem_w))
        # ModuleDict keys may not hold '.', block names hold '/' only; each
        # block carries its weights once more in the kernel's packed layout
        # (every float32 weight as its TF32 hi and lo halves)
        self.blocks = nn.ModuleDict(
            {name: _Tensors(add_packed(t)) for name, t in folded["blocks"].items()}
        )
        # the head kernel's nets, told by dtype and head shapes: float32, a 1x1
        # score head without upsampling, its width and class count
        first = folded["stacks"][0]
        self.heads_fused = (not self.bf16 and spec.head_upsample == 1
                            and first["score_w"].dim() == 2
                            and first["feat_w"].shape[0] in HEAD_WIDTHS
                            and first["score_w"].shape[1] <= HEAD_CLASSES)
        stacks = []
        for t in folded["stacks"]:
            t = {k: v.float() for k, v in t.items()}
            if spec.score_ksize > 1:
                t["score_w"] = t["score_w"].permute(3, 2, 0, 1)
            if self.heads_fused:
                t["head_packed"], t["head_biases"] = pack_heads(t)
            stacks.append(_Tensors(t))
        self.stacks = nn.ModuleList(stacks)
        self.block_fn = fused_bottleneck
        self.merge_fn = upsample2x_add
        self.stem_fn = stem_conv
        self.head_fn = stack_heads

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

    def _act(self, t: torch.Tensor) -> torch.Tensor:
        """A layer's float32 result as the trunk carries it: rounded to
        bfloat16 in a bfloat16 net, as it is in a float32 one."""
        return t.to(torch.bfloat16) if self.bf16 else t

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        stem = self.spec.stem
        x = x.float()                                   # the products in float32
        if stem == "conv":                              # relu(conv + b) in one
            y = self.stem_fn(x.contiguous(), self.stem_packed, self.stem_b)
        elif stem == "patchify":
            y = torch.relu(dot1x1(space_to_depth4(x), self.stem_w, self.stem_b))
        else:
            _, stride, padding = _PATCH_CONV[stem]
            y = torch.relu(conv_nhwc(x, self.stem_w, self.stem_b, stride=stride,
                                     padding=padding))
        y = self._act(y).contiguous()
        if stem == "conv":
            y = maxpool2(self.block("stem_res1", y))
        y = self.block("stem_res2", y)
        return self.block("stem_res3", y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        # a bfloat16 net rounds a float32 input first (fused_apply's x.astype)
        y = self._stem(self._act(x.float()) if self.bf16 else x.float())
        k, u = spec.score_ksize, spec.head_upsample
        outputs = []
        for s in range(spec.num_stacks):
            stack = self.stacks[s]
            hg = self._level(y, f"hg{s}", spec.depth)
            f = self.block(f"feat_res{s}", hg).float()
            if self.heads_fused:        # the whole chain in one launch, into stack s's slice
                if s == 0:
                    out = f.new_empty((spec.num_stacks, *f.shape[:3], spec.num_classes))
                last = s == spec.num_stacks - 1
                y = self.head_fn(f, None if last else y, stack.head_packed, stack.head_biases,
                                 out[s])
                continue
            f = self._act(torch.relu(dot1x1(f, stack.feat_w, stack.feat_b))).float()
            if k == 1:
                raw = dot1x1(f, stack.score_w, stack.score_b)
            else:
                raw = conv_nhwc(f, stack.score_w, stack.score_b, stride=1, padding=k // 2)
            outputs.append(depth_to_space(raw, u) if u > 1 else raw)
            if s < spec.num_stacks - 1:
                # y + remap(f) + remap(raw), each term and sum rounded in a bf16 net
                rf = self._act(dot1x1(f, stack.remap_feat_w, stack.remap_feat_b)).float()
                rs = self._act(dot1x1(self._act(raw).float(), stack.remap_score_w,
                                      stack.remap_score_b)).float()
                y = self._act(self._act(y.float() + rf).float() + rs).contiguous()
        return out if self.heads_fused else torch.stack(outputs)
