"""The system under test: the one module of the benchmark that imports ``deepfly3d_torch``.

``build`` makes the pipeline that the window drives,
``deepfly3d_torch.pipeline.build_pipeline(spec, variables, calib, order,
rig="auto", device)``, from what a configuration's builder made: a
checkpoint file, read by the program's own reader, or a torch state dict,
saved to a file and converted by the program's converter
(``models/convert_torch.convert_checkpoint``) as a lab converts one.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch


def build(cfg: dict, root: str, made: dict, device: torch.device):
    from deepfly3d_torch.models.hourglass import HourglassSpec, load_weights
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    if "checkpoint" in made:
        variables, spec = load_weights(made["checkpoint"])
    else:
        from deepfly3d_torch.models.convert_torch import convert_checkpoint

        s = cfg["spec"]
        spec = HourglassSpec(num_stacks=s["num_stacks"], features=s["features"],
                             depth=s["depth"], num_blocks=s["num_blocks"],
                             num_classes=s["num_classes"], stem=s["stem"],
                             input_shape=tuple(s["input_shape"]),
                             proj_from_raw=s["proj_from_raw"])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "checkpoint.pth")
            torch.save({k: v.cpu() for k, v in made["state_dict"].items()}, path)
            variables = convert_checkpoint(path, spec)
    with open(os.path.join(root, cfg["calib"]), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), cfg["num_cameras"], dtype=np.float32)
    return build_pipeline(spec, variables, calib, cfg["camera_ordering"],
                          rig=os.path.join(root, cfg["rig_template"]), device=device)
