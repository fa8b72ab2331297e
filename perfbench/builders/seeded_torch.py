"""Seeded weights in the layout of a torch stacked-hourglass checkpoint.

For a network whose published weights the repository does not hold: a
state dict under the canonical torch names (``conv1``/``bn1``,
``layer{1,2,3}.0``, ``hg.{s}.hg.{level}.{slot}.0``, ``res.{s}.0``,
``fc.{s}.{0,1}``, ``score.{s}``, ``fc_.{s}``, ``score_.{s}``; kernels OIHW,
batch norms as weight, bias, running_mean and running_var), with the
published stem of the spec's ``stem_channels`` (c0, c1, c2): a 7x7 conv
3->c0, then Residual(c0, c1), Residual(c1, c2), Residual(c2, features), each
block's middle width half its output (Newell's ``Residual``), drawn on the
device by a ``torch.Generator`` in two calls (one normal, one uniform draw),
at a trained net's scale: activations that stay bounded through the stacks
and heatmap peaks of a few units, so that the argmax is decided by the
image and not by rounding.

* convolutions: normal, std ``gain / sqrt(fan_in)`` (gain sqrt(2) for the
  blocks' first two and the feature head, 0.3 for a block's last, 2 for the
  stem, 0.3 for the score, 0.1 for the re-injections), biases normal x 0.05;
* batch norms: scale uniform in [0.8, 1.2], bias and mean normal x 0.1,
  variance uniform in [0.5, 1.5].

The reference runs the state dict as it is; the program gets it as a lab
would, a file that ``entries/pipeline.py`` converts with the program's converter.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from reference.hourglass import TorchLayout
from generator import sub_seed


def _entries(spec: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, gain) of every tensor, in draw order."""
    f, K, S, D = spec["features"], spec["num_classes"], spec["num_stacks"], spec["depth"]
    out: List[Tuple[str, tuple, str, float]] = []

    def conv(name, k, cin, cout, gain):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv", gain / math.sqrt(k * k * cin)))
        out.append((f"{name}.bias", (cout,), "normal", 0.05))

    def bn(name, c):
        out.append((f"{name}.weight", (c,), "uniform", (0.8, 1.2)))
        out.append((f"{name}.bias", (c,), "normal", 0.1))
        out.append((f"{name}.running_mean", (c,), "normal", 0.1))
        out.append((f"{name}.running_var", (c,), "uniform", (0.5, 1.5)))

    def block(name, cin, cout=f):
        mid = cout // 2
        bn(f"{name}.bn1", cin)
        conv(f"{name}.conv1", 1, cin, mid, math.sqrt(2.0))
        bn(f"{name}.bn2", mid)
        conv(f"{name}.conv2", 3, mid, mid, math.sqrt(2.0))
        bn(f"{name}.bn3", mid)
        conv(f"{name}.conv3", 1, mid, cout, 0.3)
        if cin != cout:
            conv(f"{name}.downsample.0", 1, cin, cout, 1.0)

    c0, c1, c2 = spec["stem_channels"]
    conv("conv1", 7, 3, c0, 2.0)
    bn("bn1", c0)
    for i, (cin, cout) in enumerate(((c0, c1), (c1, c2), (c2, f)), start=1):
        block(f"layer{i}.0", cin, cout)
    for s in range(S):
        for level in range(D):
            for slot in (0, 1, 2) + ((3,) if level == 0 else ()):
                block(f"hg.{s}.hg.{level}.{slot}.0", f)
        block(f"res.{s}.0", f)
        conv(f"fc.{s}.0", 1, f, f, math.sqrt(2.0))
        bn(f"fc.{s}.1", f)
        conv(f"score.{s}", 1, f, K, 0.3)
        if s < S - 1:
            conv(f"fc_.{s}", 1, f, f, 0.1)
            conv(f"score_.{s}", 1, K, f, 0.1)
    return out


def state_dict(spec: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The seeded state dict, float32 tensors on ``device``."""
    entries = _entries(spec)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in entries if k == kind)
             for kind in ("conv", "normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = torch.randn(sizes["conv"] + sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    at = {"conv": 0, "normal": sizes["conv"], "uniform": 0}
    sd = {}
    for name, shape, kind, scale in entries:
        n = math.prod(shape)
        src = uniform if kind == "uniform" else normal
        v = src[at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        sd[name] = v * (scale[1] - scale[0]) + scale[0] if kind == "uniform" else v * scale
    return sd


def make(cfg: dict, root: str, seed: int, device: torch.device) -> dict:
    del root
    sd = state_dict(cfg["spec"], seed, device)
    return {"layout": TorchLayout(sd), "state_dict": sd}


def shapes(cfg: dict, root: str) -> TorchLayout:
    """The weights ``make`` lays out, as meta tensors: their shapes, nothing drawn."""
    del root
    return TorchLayout({n: torch.empty(s, device="meta") for n, s, _, _ in _entries(cfg["spec"])})
