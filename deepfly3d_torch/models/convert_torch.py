"""PyTorch stacked-hourglass checkpoint conversion.

Counterpart of ``deepfly3d_tpu/models/convert_torch.py``.  The reference's
2D network weights ship as a torch checkpoint of the classic
stacked-hourglass lineage (``weights/sh8_deepfly.tar``, not in the
repository).  This module converts such a state dict into the variables
tree both packages use (``{"params", "batch_stats"}``, flax names and
layouts):

* convolution kernels: OIHW -> HWIO transpose
* batch-norm: (weight, bias, running_mean, running_var) ->
  (scale, bias) params + (mean, var) batch_stats
* module-tree mapping driven by a name table for the canonical
  ``conv1 / bn1 / layerN / hg / res / fc / score / fc_ / score_`` layout,
  with the hourglass level list innermost-first (torch level L is recursion
  depth L + 1)

and ``main`` writes it with the port's ``save_weights``, a checkpoint that
both packages' ``load_weights`` read.  Specs for converted checkpoints set
``proj_from_raw=True``: the canonical torch Bottleneck projects the raw
block input, which the port's folded forward runs in the bottleneck
kernel's raw projection (the converter's default 256-wide output in its
general instance, ``ops/csrc/bottleneck_general.cu``).  Mismatches raise
with the list of unmapped keys rather than mis-assigning.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deepfly3d_torch.models.hourglass import HourglassSpec, save_weights


def conv_to_flax(weight: np.ndarray, bias=None) -> Dict[str, np.ndarray]:
    """torch conv (O, I, H, W) -> flax {'kernel': (H, W, I, O), 'bias'}."""
    out = {"kernel": np.transpose(np.asarray(weight), (2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def bn_to_flax(prefix: str, sd: Dict[str, np.ndarray]):
    """-> (params {'scale','bias'}, stats {'mean','var'})."""
    params = {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }
    stats = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "var": np.asarray(sd[f"{prefix}.running_var"]),
    }
    return params, stats


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint file to a flat {name: ndarray} dict.

    Handles both bare state dicts and trainer checkpoints that nest the
    weights under 'state_dict' (and strips DataParallel 'module.' prefixes).
    The file is read with ``weights_only=True``: tensors, containers and
    numbers only, nothing else is unpickled (the JAX reader unpickles
    anything).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            # torch BN bookkeeping buffer (present in every real
            # checkpoint since torch 0.4); no flax counterpart
            continue
        out[k] = v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


# Our flax module names for the stem and per-stack heads
# (see models/hourglass.py) keyed by the canonical torch names.
_STEM_MAP = {
    "conv1": ("stem_conv", "conv"),
    "bn1": ("stem_bn", "bn"),
}


def _bottleneck_map(torch_prefix: str, flax_name: str):
    """Canonical torch Bottleneck(bn1,conv1,bn2,conv2,bn3,conv3,downsample)
    -> our pre-activation Bottleneck module names."""
    return [
        (f"{torch_prefix}.bn1", (f"{flax_name}/bn1", "bn")),
        (f"{torch_prefix}.conv1", (f"{flax_name}/conv1", "conv")),
        (f"{torch_prefix}.bn2", (f"{flax_name}/bn2", "bn")),
        (f"{torch_prefix}.conv2", (f"{flax_name}/conv2", "conv")),
        (f"{torch_prefix}.bn3", (f"{flax_name}/bn3", "bn")),
        (f"{torch_prefix}.conv3", (f"{flax_name}/conv3", "conv")),
        (f"{torch_prefix}.downsample.0", (f"{flax_name}/proj", "conv")),
    ]


def convert_state_dict(
    sd: Dict[str, np.ndarray], spec: HourglassSpec, strict: bool = True
) -> Tuple[dict, dict]:
    """Flat torch state dict -> (params, batch_stats) nested flax trees.

    Covers the canonical stacked-hourglass layout; raises with the list of
    unconverted tensors when `strict` and anything is left over.
    """
    params: dict = {}
    stats: dict = {}
    consumed = set()

    def put(tree, path, leaf):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    def take_conv(torch_prefix, flax_path):
        w = f"{torch_prefix}.weight"
        if w not in sd:
            return False
        b = sd.get(f"{torch_prefix}.bias")
        leaf = conv_to_flax(sd[w], b)
        put(params, tuple(flax_path.split("/")), leaf)
        consumed.update({w} | ({f"{torch_prefix}.bias"} if b is not None else set()))
        return True

    def take_bn(torch_prefix, flax_path):
        if f"{torch_prefix}.weight" not in sd:
            return False
        p, s = bn_to_flax(torch_prefix, sd)
        put(params, tuple(flax_path.split("/")), p)
        put(stats, tuple(flax_path.split("/")), s)
        consumed.update(
            {
                f"{torch_prefix}.weight",
                f"{torch_prefix}.bias",
                f"{torch_prefix}.running_mean",
                f"{torch_prefix}.running_var",
            }
        )
        return True

    # stem
    take_conv("conv1", "stem_conv")
    take_bn("bn1", "stem_bn")
    for i, name in enumerate(("stem_res1", "stem_res2", "stem_res3"), start=1):
        for tp, (fp, kind) in _bottleneck_map(f"layer{i}.0", name):
            (take_bn if kind == "bn" else take_conv)(tp, fp)

    # per-stack modules
    for s in range(spec.num_stacks):
        # hourglass residuals: canonical names hg.{s}.hg.{level}.{slot}.0.
        # In the canonical torch lineage the level list is built innermost-
        # first: hg[0] carries the deepest level's blocks (plus the extra
        # innermost residual at slot 3) and the top of the recursion reads
        # hg[depth-1]; our names count RECURSION depth d (top = depth), so
        # torch level L maps to d = L + 1.  Pinned against a real torch
        # forward in tests/test_convert_torch_forward.py — the pre-round-4
        # depth-level mapping was inverted, which every same-width
        # architecture converts "successfully" but computes wrongly.
        for level in range(spec.depth):
            d = level + 1
            slot_to_name = {
                0: f"hg{s}/skip_d{d}_0",
                1: f"hg{s}/down_d{d}_0",
                2: f"hg{s}/up_d{d}_0",
                3: f"hg{s}/innermost_0",
            }
            for slot, flax_name in slot_to_name.items():
                tp = f"hg.{s}.hg.{level}.{slot}.0"
                if f"{tp}.bn1.weight" not in sd:
                    continue
                for tpp, (fp, kind) in _bottleneck_map(tp, flax_name):
                    (take_bn if kind == "bn" else take_conv)(tpp, fp)
        # heads
        for tp, (fp, kind) in _bottleneck_map(f"res.{s}.0", f"feat_res{s}"):
            (take_bn if kind == "bn" else take_conv)(tp, fp)
        take_conv(f"fc.{s}.conv", f"feat_conv{s}")
        take_conv(f"fc.{s}.0", f"feat_conv{s}")
        take_bn(f"fc.{s}.bn", f"feat_bn{s}")
        take_bn(f"fc.{s}.1", f"feat_bn{s}")
        take_conv(f"score.{s}", f"score{s}")
        take_conv(f"fc_.{s}", f"remap_feat{s}")
        take_conv(f"score_.{s}", f"remap_score{s}")

    leftover = sorted(set(sd) - consumed)
    if strict and leftover:
        raise ValueError(
            f"{len(leftover)} tensors could not be mapped to the flax tree "
            f"(architecture mismatch?): {leftover[:20]}..."
        )
    return params, stats


def convert_checkpoint(path: str, spec: HourglassSpec, strict: bool = True):
    """torch checkpoint file -> flax variables {'params', 'batch_stats'}."""
    sd = load_torch_state_dict(path)
    params, stats = convert_state_dict(sd, spec, strict=strict)
    return {"params": params, "batch_stats": stats}


def main(argv=None) -> int:
    """CLI: ``python -m deepfly3d_torch.models.convert_torch IN.tar OUT.npz``.

    Architecture flags must match the checkpoint (strict mode lists every
    unmapped tensor on mismatch).  Defaults target the df2d sh8 lineage;
    ``proj_from_raw`` is forced True — canonical torch Bottlenecks project
    the raw block input (see module docstring).
    """
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("torch_ckpt", help="torch checkpoint (.tar/.pth)")
    p.add_argument("out_npz", help="output flax checkpoint (.npz)")
    p.add_argument("--stacks", type=int, default=2)
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--classes", type=int, default=19)
    p.add_argument("--input-shape", type=int, nargs=2, default=(256, 512),
                   metavar=("H", "W"),
                   help="training resolution recorded in the checkpoint")
    p.add_argument("--lenient", action="store_true",
                   help="skip (do not fail on) unmapped tensors")
    args = p.parse_args(argv)

    spec = HourglassSpec(
        num_stacks=args.stacks, features=args.features, depth=args.depth,
        num_blocks=1, num_classes=args.classes, stem="conv",
        input_shape=tuple(args.input_shape), proj_from_raw=True,
    )
    variables = convert_checkpoint(
        args.torch_ckpt, spec, strict=not args.lenient
    )
    save_weights(args.out_npz, variables, spec)
    n = sum(
        np.asarray(v).size
        for tree in variables.values()
        for v in _iter_leaves(tree)
    )
    print(f"converted {args.torch_ckpt} -> {args.out_npz} "
          f"({n/1e6:.2f} M params+stats, spec={spec.num_stacks}s-"
          f"f{spec.features}-d{spec.depth}, proj_from_raw=True)")
    return 0


def _iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


if __name__ == "__main__":
    import sys

    sys.exit(main())
