"""Weights from a checkpoint file of the repository (flax names, HWIO kernels).

The reference reads the ``.npz`` itself; the program loads it with its own
reader (``entries/``).  The file's sha256 must be the configuration's.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from reference.hourglass import FlaxLayout


def make(cfg: dict, root: str, seed: int, device: torch.device) -> dict:
    del seed
    path = os.path.join(root, cfg["checkpoint"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cfg["checkpoint_sha256"]:
        raise RuntimeError(f"{cfg['checkpoint']}: sha256 {digest}, the configuration "
                           f"states {cfg['checkpoint_sha256']}")
    with np.load(path) as z:
        tensors = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                   for k in z.files if not k.startswith("__spec__/")}
    return {"layout": FlaxLayout(tensors), "checkpoint": path}


def shapes(cfg: dict, root: str) -> FlaxLayout:
    """The checkpoint's weights as ``make`` lays them out, as meta tensors:
    their shapes, no value kept."""
    with np.load(os.path.join(root, cfg["checkpoint"])) as z:
        return FlaxLayout({k: torch.empty(z[k].shape, device="meta")
                           for k in z.files if not k.startswith("__spec__/")})
