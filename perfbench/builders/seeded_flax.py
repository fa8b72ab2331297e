"""Seeded weights in the layout of this repository's checkpoints (flax names, HWIO kernels).

For a network whose trained weights the repository does not hold (the h36m
profile's): the flat ``.npz`` arrays that the program's checkpoint reader
takes, ``params/<module>/kernel`` and ``bias``, ``params/<bn>/scale`` and
``bias``, ``batch_stats/<bn>/mean`` and ``var``, and the ``__spec__/*``
fields, drawn as ``deepfly3d_torch/utils/synthetic.random_checkpoint``
draws them: one ``numpy.random.default_rng`` stream in key order, float64
cast to float32, at a trained net's scale (activations that stay bounded
through four stacks, heatmap peaks of ~2):

* convolutions: normal, std ``gain / sqrt(fan_in)`` (gain sqrt(2) for the
  blocks' first two and the feature head, 0.3 for a block's last, 1 for a
  projection, 2 for the stem, 0.06 for the score, 0.1 for the
  re-injections), biases normal x 0.05;
* batch norms: scale uniform in [0.8, 1.2], bias and mean normal x 0.1,
  variance uniform in [0.5, 1.5].

The layout's stem is the flax net's, ``stem_channels`` = [features / 2,
features, features].  The reference reads the arrays through
``FlaxLayout``; the program gets them as a file (``entries/``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from generator import sub_seed
from reference.hourglass import FlaxLayout


def _block_names(spec: dict) -> List[str]:
    names = ["stem_res1", "stem_res2", "stem_res3"]

    def walk(prefix, d):
        names.extend([f"{prefix}/skip_d{d}_0", f"{prefix}/down_d{d}_0"])
        if d > 1:
            walk(prefix, d - 1)
        else:
            names.append(f"{prefix}/innermost_0")
        names.append(f"{prefix}/up_d{d}_0")

    for s in range(spec["num_stacks"]):
        walk(f"hg{s}", spec["depth"])
        names.append(f"feat_res{s}")
    return names


def _entries(spec: dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(key, shape, draw, its parameters) of every array, in draw order."""
    f, K, S = spec["features"], spec["num_classes"], spec["num_stacks"]
    if spec["num_blocks"] != 1 or spec["stem_channels"] != [f // 2, f, f]:
        raise ValueError("the flax layout's conv stem is [features / 2, features, features], "
                         "one block a level")
    mid = f // spec["expansion"]
    out: List[Tuple[str, tuple, str, tuple]] = []

    def conv(name, k, cin, cout, gain=1.0):
        out.append((f"params/{name}/kernel", (k, k, cin, cout), "normal",
                    (gain / math.sqrt(k * k * cin),)))
        out.append((f"params/{name}/bias", (cout,), "normal", (0.05,)))

    def bn(name, c):
        out.append((f"params/{name}/scale", (c,), "uniform", (0.8, 1.2)))
        out.append((f"params/{name}/bias", (c,), "normal", (0.1,)))
        out.append((f"batch_stats/{name}/mean", (c,), "normal", (0.1,)))
        out.append((f"batch_stats/{name}/var", (c,), "uniform", (0.5, 1.5)))

    def block(name, cin):
        bn(f"{name}/bn1", cin)
        conv(f"{name}/conv1", 1, cin, mid, math.sqrt(2.0))
        bn(f"{name}/bn2", mid)
        conv(f"{name}/conv2", 3, mid, mid, math.sqrt(2.0))
        bn(f"{name}/bn3", mid)
        conv(f"{name}/conv3", 1, mid, f, 0.3)
        if cin != f:
            conv(f"{name}/proj", 1, cin, f)

    conv("stem_conv", 7, 3, f // 2, 2.0)
    bn("stem_bn", f // 2)
    for name in _block_names(spec):
        block(name, f // 2 if name == "stem_res1" else f)
        if name.startswith("feat_res"):
            i = int(name[len("feat_res"):])
            conv(f"feat_conv{i}", 1, f, f, math.sqrt(2.0))
            bn(f"feat_bn{i}", f)
            conv(f"score{i}", 1, f, K, 0.06)
            if i < S - 1:
                conv(f"remap_feat{i}", 1, f, f, 0.1)
                conv(f"remap_score{i}", 1, K, f, 0.1)
    return out


def arrays(spec: dict, seed: int) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays drawn from ``seed`` (a ``numpy`` seed), and its
    ``__spec__`` fields."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape, draw, p in _entries(spec):
        if draw == "normal":
            v = rng.standard_normal(shape) * p[0]
        else:
            v = rng.uniform(p[0], p[1], shape)
        out[key] = np.asarray(v, np.float32)
    meta = {"num_stacks": spec["num_stacks"], "features": spec["features"],
            "depth": spec["depth"], "num_blocks": spec["num_blocks"],
            "num_classes": spec["num_classes"], "expansion": spec["expansion"],
            "bn_momentum": 0.99, "stem": spec["stem"], "head_upsample": 1,
            "input_shape": np.asarray(spec["input_shape"], np.int64)}
    out.update({f"__spec__/{k}": np.asarray(v) for k, v in meta.items()})
    return out


def make(cfg: dict, root: str, seed: int, device: torch.device) -> dict:
    """-> ``layout`` (the weights on ``device``, for the reference) and
    ``checkpoint_arrays`` (the file's arrays, numpy, for the program)."""
    del root
    flat = arrays(cfg["spec"], sub_seed(seed, "weights"))
    tensors = {k: torch.from_numpy(v).to(device) for k, v in flat.items()
               if not k.startswith("__spec__/")}
    return {"layout": FlaxLayout(tensors), "checkpoint_arrays": flat}


def shapes(cfg: dict, root: str) -> FlaxLayout:
    """The weights ``make`` lays out, as meta tensors: their shapes, nothing drawn."""
    del root
    return FlaxLayout({k: torch.empty(s, device="meta") for k, s, _, _ in _entries(cfg["spec"])})
