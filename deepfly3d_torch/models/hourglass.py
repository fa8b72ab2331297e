"""Stacked-hourglass architecture spec, checkpoint files and the trainable network.

Counterpart of ``deepfly3d_tpu/models/hourglass.py`` without flax:

* ``HourglassSpec``, ``load_weights`` and ``save_weights``: a checkpoint is
  a flat ``.npz`` whose keys are ``a/b/c`` paths into the flax variable
  tree plus ``__spec__/<field>`` entries, so either package's reader takes
  either package's file; ``load_weights`` returns the nested dict of numpy
  arrays (the *variables*: ``{"params", "batch_stats"}``, convolution
  kernels HWIO) that the JAX reader returns.
* ``HourglassNet``: the unfolded network with training-mode batch norm,
  for training (``models/train.py``), in float32 or, as flax computes it,
  bfloat16.  Its modules carry the flax names, so
  ``load_variables`` / ``module_variables`` carry a variables tree into its
  parameters and buffers and back (kernels HWIO <-> OIHW).  It runs plain
  PyTorch (cuDNN convolutions on a card), as the flax graph runs XLA: the
  JAX package's training reaches no Pallas kernel.
* ``init_params``: flax's initialisers drawn from a ``torch.Generator``.

The serving forward is ``models/fused_inference.py`` (folded batch norms,
CUDA blocks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfly3d_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class HourglassSpec:
    """Architecture hyperparameters (same fields and defaults as the JAX spec).

    ``compute_dtype`` is a dtype name here; checkpoints never store it.
    """

    num_stacks: int = 2
    features: int = 64
    depth: int = 4
    num_blocks: int = 1
    num_classes: int = 19
    expansion: int = 2
    proj_from_raw: bool = False
    compute_dtype: str = "float32"
    bn_momentum: float = 0.99
    stem: str = "conv"
    head_upsample: int = 1
    score_ksize: int = 1
    input_shape: Optional[Tuple[int, int]] = None
    hp_scope: Optional[str] = None
    hp_precision: str = "highest"
    preprocess_dtype: str = "float32"


_STR_FIELDS = ("stem", "hp_scope", "hp_precision", "preprocess_dtype")
_INT_FIELDS = ("num_stacks", "features", "depth", "num_blocks", "num_classes",
               "expansion", "head_upsample", "score_ksize")


def _spec_value(field: str, raw: np.ndarray) -> Any:
    if field == "input_shape":
        return tuple(int(v) for v in raw)
    value = raw.item()
    if field in _STR_FIELDS:
        return str(value)
    if field == "bn_momentum":
        return float(value)
    if field == "proj_from_raw":
        return bool(int(value))
    if field in _INT_FIELDS:
        return int(value)
    raise ValueError(f"checkpoint has an unknown spec field {field!r}")


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_weights(path: str):
    """-> (variables, HourglassSpec); ``variables`` is a nested dict of numpy.

    Raises ValueError on a ``__spec__`` field the spec does not know: the
    reader never guesses what a checkpoint means.
    """
    with np.load(path) as data:
        spec_kwargs = {}
        arrays = {}
        for k in data.files:
            if k.startswith("__spec__/"):
                field = k.split("/", 1)[1]
                spec_kwargs[field] = _spec_value(field, data[k])
            else:
                arrays[k] = np.asarray(data[k])
    return _unflatten(arrays), HourglassSpec(**spec_kwargs)


# ------------------------------------------------------------ save_weights


def save_weights(path: str, variables, spec: HourglassSpec) -> None:
    """Flat ``.npz`` checkpoint with the keys and ``__spec__`` entries of the
    JAX ``save_weights`` (``variables``: numpy arrays or tensors)."""
    meta = {
        "__spec__/num_stacks": spec.num_stacks,
        "__spec__/features": spec.features,
        "__spec__/depth": spec.depth,
        "__spec__/num_blocks": spec.num_blocks,
        "__spec__/num_classes": spec.num_classes,
        "__spec__/expansion": spec.expansion,
        "__spec__/bn_momentum": float(spec.bn_momentum),
        "__spec__/stem": spec.stem,
        "__spec__/head_upsample": spec.head_upsample,
    }
    if spec.input_shape is not None:
        meta["__spec__/input_shape"] = np.asarray(spec.input_shape, np.int64)
    if spec.hp_scope is not None:
        meta["__spec__/hp_scope"] = spec.hp_scope
        meta["__spec__/hp_precision"] = spec.hp_precision
    if spec.preprocess_dtype != "float32":
        meta["__spec__/preprocess_dtype"] = spec.preprocess_dtype
    if spec.score_ksize != 1:
        meta["__spec__/score_ksize"] = spec.score_ksize
    if spec.proj_from_raw:
        meta["__spec__/proj_from_raw"] = 1
    arrays = {"/".join(k): np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
              for k, v in _flatten_leaves(variables)}
    np.savez(path, **arrays, **{k: np.asarray(v) for k, v in meta.items()})


# ------------------------------------------------------- trainable network

BN_EPS = 1e-5                   # flax.linen.BatchNorm default
_KERNEL_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


TRAIN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_trainable(spec: HourglassSpec) -> None:
    """Raise ValueError for a spec the trainable network does not compute."""
    if spec.compute_dtype not in TRAIN_DTYPES:
        raise ValueError(f"compute_dtype={spec.compute_dtype!r}: the trainable network "
                         f"computes in one of {tuple(TRAIN_DTYPES)}")
    if spec.stem not in ("conv", "patchify", "patch8", "patch16"):
        raise ValueError(f"unknown stem {spec.stem!r}")
    if spec.score_ksize < 1 or spec.score_ksize % 2 == 0:
        raise ValueError(f"score_ksize={spec.score_ksize}: odd k only (SAME padding)")


class Conv(nn.Module):
    """k x k convolution with bias on NCHW tensors (flax ``nn.Conv``,
    symmetric zero padding).

    On a bfloat16 input it computes as flax's ``nn.Conv(dtype=bfloat16)``:
    the weight and bias rounded to bfloat16, the convolution's result
    rounded to bfloat16, then the bias added and the sum rounded again.
    """

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
            return y + self.bias.to(x.dtype)[:, None, None]
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor.

    Training mode normalises with the batch's statistics, computed as flax
    computes them: mean E[x] and the biased variance E[x^2] - E[x]^2 clipped
    at 0, in float32 (not ``nn.BatchNorm2d``'s Welford sums and unbiased
    running variance), and moves the running statistics by
    ``ra = m * ra + (1 - m) * batch``.  ``sync`` (``parallel/pipeline``)
    supplies (E[x], E[x^2]) over every replica's batch; only the replica
    that ``sync.writes`` moves the running statistics.

    A bfloat16 input is taken to float32 for the statistics and the
    normalisation, against the float32 parameters and statistics, and only
    the output is rounded to bfloat16 (flax at ``dtype=bfloat16`` with its
    float32 reductions).
    """

    def __init__(self, c: int, momentum: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.momentum = momentum

    def forward(self, x: torch.Tensor, train: bool, sync=None) -> torch.Tensor:
        dtype, x = x.dtype, x.float()
        if train:
            if sync is None:
                mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            else:
                mean, mean_sq = sync.moments(x)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if sync is None or sync.writes:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(dtype)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck residual block (flax ``Bottleneck``)."""

    def __init__(self, cin: int, features: int, momentum: float, proj_from_raw: bool):
        super().__init__()
        mid = features // 2
        self.bn1 = BatchNorm(cin, momentum)
        if cin != features:
            self.proj = Conv(cin, features)
        self.conv1 = Conv(cin, mid)
        self.bn2 = BatchNorm(mid, momentum)
        self.conv2 = Conv(mid, mid, 3, padding=1)
        self.bn3 = BatchNorm(mid, momentum)
        self.conv3 = Conv(mid, features)
        self.proj_from_raw = proj_from_raw

    def forward(self, x: torch.Tensor, train: bool, sync=None) -> torch.Tensor:
        y = torch.relu(self.bn1(x, train, sync))
        residual = x
        if hasattr(self, "proj"):
            # the skip projects the raw input (torch lineage) or relu(bn1(x))
            residual = self.proj(x if self.proj_from_raw else y)
        y = torch.relu(self.bn2(self.conv1(y), train, sync))
        y = torch.relu(self.bn3(self.conv2(y), train, sync))
        return self.conv3(y) + residual


class Hourglass(nn.Module):
    """Recursive encoder/decoder with skip residuals at every level; blocks
    named as in flax (``skip_d{d}_{i}``, ``down_d{d}_{i}``, ``innermost_{i}``,
    ``up_d{d}_{i}``)."""

    def __init__(self, features: int, depth: int, num_blocks: int, momentum: float,
                 proj_from_raw: bool):
        super().__init__()
        self.depth, self.num_blocks = depth, num_blocks
        names = [f"{kind}_d{d}_" for d in range(depth, 0, -1) for kind in ("skip", "down", "up")]
        for name in names + ["innermost_"]:
            for i in range(num_blocks):
                self.add_module(f"{name}{i}",
                                Bottleneck(features, features, momentum, proj_from_raw))

    def _blocks(self, y, name, train, sync):
        for i in range(self.num_blocks):
            y = getattr(self, f"{name}{i}")(y, train, sync)
        return y

    def _level(self, y, d, train, sync):
        skip = self._blocks(y, f"skip_d{d}_", train, sync)
        down = self._blocks(F.max_pool2d(y, 2, 2), f"down_d{d}_", train, sync)
        if d > 1:
            inner = self._level(down, d - 1, train, sync)
        else:
            inner = self._blocks(down, "innermost_", train, sync)
        inner = self._blocks(inner, f"up_d{d}_", train, sync)
        return skip + F.interpolate(inner, scale_factor=2, mode="nearest")

    def forward(self, x, train: bool, sync=None):
        return self._level(x, self.depth, train, sync)


_PATCH_CONV = {"patch16": (16, 8, 4), "patch8": (8, 4, 2)}   # kernel, stride, padding


class HourglassNet(nn.Module):
    """The trainable stacked hourglass (flax ``HourglassNet``).

    ``forward(x, train=False, sync=None)`` maps NHWC (N, H, W, 3) to float32
    (num_stacks, N, H/4, W/4, K), the flax contract; inside, activations are
    NCHW views of channels-last memory, which cuDNN takes as they are.
    ``train=True`` normalises with batch statistics and moves the running
    statistics in place (the flax ``mutable=["batch_stats"]`` update).
    ``capture=True`` also returns the last stack's ``feat_bn`` output, before
    its ReLU and in the trunk's dtype (what flax's ``capture_intermediates``
    records for that module).

    ``compute_dtype="bfloat16"`` runs flax's bfloat16 graph with flax's
    roundings: the input rounded to bfloat16, every trunk convolution and
    batch norm as ``Conv`` and ``BatchNorm`` compute a bfloat16 input, the
    residual adds, merges and re-injection sums in bfloat16, and the score
    convolutions in float32 on a float32 copy of their input; parameters and
    statistics stay float32.  ``hp_scope`` is accepted and ignored: every
    float32 product runs in float32.  Raises ValueError for another dtype.
    """

    def __init__(self, spec: HourglassSpec):
        super().__init__()
        check_trainable(spec)
        self.spec = spec
        f, m, raw = spec.features, spec.bn_momentum, spec.proj_from_raw
        if spec.stem == "conv":
            self.stem_conv = Conv(3, f // 2, 7, stride=2, padding=3)
            self.stem_bn = BatchNorm(f // 2, m)
            self.stem_res1 = Bottleneck(f // 2, f, m, raw)
        else:
            if spec.stem == "patchify":
                self.patch_embed = Conv(48, f)
            else:
                k, stride, pad = _PATCH_CONV[spec.stem]
                self.patch_embed = Conv(3, f, k, stride=stride, padding=pad)
            self.stem_bn = BatchNorm(f, m)
        self.stem_res2 = Bottleneck(f, f, m, raw)
        self.stem_res3 = Bottleneck(f, f, m, raw)
        k, u = spec.score_ksize, spec.head_upsample
        for i in range(spec.num_stacks):
            self.add_module(f"hg{i}", Hourglass(f, spec.depth, spec.num_blocks, m, raw))
            self.add_module(f"feat_res{i}", Bottleneck(f, f, m, raw))
            self.add_module(f"feat_conv{i}", Conv(f, f))
            self.add_module(f"feat_bn{i}", BatchNorm(f, m))
            self.add_module(f"score{i}", Conv(f, spec.num_classes * u * u, k, padding=k // 2))
            if i < spec.num_stacks - 1:
                self.add_module(f"remap_feat{i}", Conv(f, f))
                self.add_module(f"remap_score{i}", Conv(spec.num_classes * u * u, f))

    def _stem(self, x, train, sync):
        stem = self.spec.stem
        if stem == "conv":
            y = torch.relu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2)), train, sync))
            y = F.max_pool2d(self.stem_res1(y, train, sync), 2, 2)
        else:
            if stem == "patchify":
                from deepfly3d_torch.models.fused_inference import space_to_depth4

                y = self.patch_embed(space_to_depth4(x).permute(0, 3, 1, 2))
            else:
                y = self.patch_embed(x.permute(0, 3, 1, 2))
            y = torch.relu(self.stem_bn(y, train, sync))
        y = self.stem_res2(y, train, sync)
        return self.stem_res3(y, train, sync)

    def forward(self, x: torch.Tensor, train: bool = False, sync=None, capture: bool = False):
        from deepfly3d_torch.models.fused_inference import depth_to_space

        spec = self.spec
        dt = TRAIN_DTYPES[spec.compute_dtype]
        u = spec.head_upsample
        y = self._stem(x.to(dt), train, sync)
        outputs = []
        for i in range(spec.num_stacks):
            hg = getattr(self, f"hg{i}")(y, train, sync)
            f = getattr(self, f"feat_res{i}")(hg, train, sync)
            bn_out = getattr(self, f"feat_bn{i}")(getattr(self, f"feat_conv{i}")(f), train, sync)
            f = torch.relu(bn_out)
            raw = getattr(self, f"score{i}")(f.float())
            score = raw.permute(0, 2, 3, 1)
            outputs.append(depth_to_space(score, u) if u > 1 else score)
            if i < spec.num_stacks - 1:
                # re-inject features and the pre-shuffle predictions
                y = y + getattr(self, f"remap_feat{i}")(f) \
                    + getattr(self, f"remap_score{i}")(raw.to(dt))
        heatmaps = torch.stack(outputs)
        return (heatmaps, bn_out) if capture else heatmaps


# ------------------------------------------------------- weight carry-over

_PARAM_LEAF = {"weight": "kernel", "bias": "bias", "scale": "scale"}


def module_state(variables) -> Dict[str, torch.Tensor]:
    """A variables tree -> ``{HourglassNet parameter or buffer name: tensor}``
    (kernels as OIHW views of the HWIO leaves, numpy leaves as tensors):
    the names ``functional_call`` and ``load_variables`` take."""
    out = {}
    for collection in ("params", "batch_stats"):
        for key, leaf in _flatten_leaves(variables[collection]):
            *path, name = key
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
            if name == "kernel":
                name, t = "weight", t.permute(3, 2, 0, 1)    # HWIO -> OIHW
            out[".".join(path + [name])] = t
    return out


def _flatten_leaves(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_variables(net: HourglassNet, variables) -> HourglassNet:
    """Copy a variables tree (``{"params", "batch_stats"}``, numpy arrays or
    tensors, flax layout) into ``net``'s parameters and buffers, in place.
    Raises ValueError for a leaf the tree lacks or has in excess, or for a
    shape that differs."""
    state = module_state(variables)
    own = dict(net.named_parameters())
    own.update(net.named_buffers())
    if sorted(state) != sorted(own):
        raise ValueError(f"variables do not fit the net: missing {sorted(set(own) - set(state))}, "
                         f"extra {sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(state[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: variables hold {tuple(state[name].shape)}, the net "
                                 f"{tuple(t.shape)}")
            t.copy_(state[name])
    return net


def _variables(net: HourglassNet, to_numpy: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for collection, items in (("params", net.named_parameters()),
                              ("batch_stats", net.named_buffers())):
        for name, t in items:
            *path, leaf = name.split(".")
            value = t.detach()
            if leaf == "weight":
                value = value.permute(2, 3, 1, 0)            # OIHW -> HWIO
            node = out[collection]
            for part in path:
                node = node.setdefault(part, {})
            # numpy leaves are copies: a snapshot, not a view of the live tensors
            node[_PARAM_LEAF.get(leaf, leaf)] = (np.array(value.cpu().numpy(), order="C")
                                                 if to_numpy else value.contiguous())
    return out


def module_variables(net: HourglassNet) -> Dict[str, Any]:
    """``net``'s parameters and buffers as a variables tree of float32 numpy
    arrays in the flax layout (what ``load_weights`` returns)."""
    return _variables(net, to_numpy=True)


def init_params(spec: HourglassSpec, input_shape: Tuple[int, int],
                generator: Optional[torch.Generator] = None, device="cuda") -> Dict[str, Any]:
    """Initialise ``{"params", "batch_stats"}`` as flax does, drawn from
    ``generator`` (its device must be ``device``): convolution kernels
    ``lecun_normal`` (a normal truncated to two standard deviations, scaled
    to std sqrt(1/fan_in)), zero biases, batch-norm scale 1, bias 0, mean 0
    and variance 1.  Returns the variables tree of tensors on ``device`` in
    the flax layout (kernels HWIO).  The draws are not JAX's: to run both
    packages on the same weights, carry JAX's over (``load_variables``).
    ``input_shape`` is the (h, w) the network is meant for; the weights do
    not depend on it (the convolutions are shape-polymorphic), as in flax.
    """
    del input_shape
    net = HourglassNet(spec).to(resolve_device(device))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                std = math.sqrt(1.0 / fan_in) / _KERNEL_TRUNC
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return _variables(net, to_numpy=False)


def trainable(variables, spec: HourglassSpec, device="cuda") -> HourglassNet:
    """A ``HourglassNet`` on ``device`` (the card unless the CPU is asked
    for) holding ``variables``."""
    return load_variables(HourglassNet(spec), variables).to(resolve_device(device))
