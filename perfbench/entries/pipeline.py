"""The 2D->3D call: ``deepfly3d_torch.pipeline.Pipeline.__call__`` on one chunk.

The program is ``build_pipeline(spec, variables, calib, order, rig, device)``,
from what a configuration's builder made: a checkpoint file, read by the
program's own reader, or a torch state dict, saved to a file and converted by
the program's converter (``models/convert_torch.convert_checkpoint``) as a
lab converts one; the configuration's ``dtype`` is the spec's
``compute_dtype``.  One call takes a chunk (T, C, H, W, 3) uint8 on the
device or in pinned memory and returns (points3d, points2d38, conf).  The
reference is ``reference/pipeline.run``, the judge ``compare.judge_call``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Dict

import numpy as np
import torch

import compare

NAMES = compare.NAMES
MAXED = ("mismatched",)
SUMMED = ("seen", "determined")


def build(cell, root: str, made: dict, device: torch.device):
    from deepfly3d_torch.models.hourglass import HourglassSpec, load_weights
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    cfg = cell.cfg
    if cfg.get("tf32"):
        raise ValueError(f"{cfg['name']}: tf32 true is not honoured: the program computes "
                         "float32 products in full float32")
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
    # checkpoints never store the arithmetic; the fold refuses a dtype it has no path for
    spec = dataclasses.replace(spec, compute_dtype=cfg["dtype"])
    with open(os.path.join(root, cfg["calib"]), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), cfg["num_cameras"], dtype=np.float32)
    return build_pipeline(spec, variables, calib, cfg["camera_ordering"],
                          rig=os.path.join(root, cfg["rig_template"]), device=device)


def reference(cell, pool, made: dict, device, root: str, tf32: bool = False):
    """-> ({chunk: reference/pipeline.Result}, rig)."""
    from reference import hourglass
    from reference import pipeline as ref

    rig = ref.load_rig(cell.cfg, root)
    net = hourglass.Hourglass(made["layout"], cell.cfg["spec"], cell.cfg["spec"]["proj_from_raw"])
    hw = tuple(cell.cfg["image_hw"])
    return {k: ref.run(chunk.to(device), net, rig, hw, tf32=tf32)
            for k, chunk in enumerate(pool)}, rig


def judge_call(cell, arrays, refs, k: int) -> Dict:
    results, rig = refs
    return compare.judge_call(arrays, results[k], rig, tuple(cell.cfg["image_hw"]))


def keep(program):
    return None


def notes(got: Dict, kept, refs) -> list:
    share = 100.0 * got["determined"] / max(got["seen"], 1)
    return [f"points differing from the reference's: {got['mismatched']} at most in a "
            f"call; distinct outputs judged: {got['distinct_outputs']}",
            f"3D points seen by two cameras or more: {got['seen']}; judged by p3d_err: "
            f"{got['determined']} ({share:.2f}%), the rest by p3d_resid alone"]


def faults(cell, s, outs) -> Dict[str, list]:
    """The previous chunk's outputs (stale state), half of the frames computed
    and the rest copied from them, one 2D point moved one cell, one frame's 3D
    points moved by 1%, and one frame's 3D points zeroed."""
    n = len(outs)
    stale = [outs[(k - 1) % n] for k in range(n)]
    half = []
    for chunk in s.pool:
        T = chunk.shape[0]
        p3d, p38, conf = (t.cpu() for t in s.prog(chunk[: T // 2]))
        half.append((torch.cat([p3d, p3d], 0)[:T], torch.cat([p38, p38], 1)[:, :T],
                     torch.cat([conf, conf], 1)[:, :T]))
    cam = int(cell.cfg["camera_ordering"][0])         # a left camera: joint 0 carries a cell
    moved2d, moved3d, zeroed3d = [], [], []
    for p3d, p38, conf in outs:
        p38_moved, p3d_moved, p3d_zeroed = p38.clone(), p3d.clone(), p3d.clone()
        p38_moved[cam, 0, 0, 0] += 1.0 / 64
        p3d_moved[0] *= 1.01
        p3d_zeroed[0] = 0.0
        moved2d.append((p3d, p38_moved, conf))
        moved3d.append((p3d_moved, p38, conf))
        zeroed3d.append((p3d_zeroed, p38, conf))
    return {"stale": stale, "half_batch": half, "moved_2d_point": moved2d,
            "moved_3d_frame": moved3d, "zeroed_3d_frame": zeroed3d}


def control_outputs(refs) -> list:
    """The reference's own results in the program's output layout, per chunk."""
    return [(r.points3d, r.points2d, r.conf) for r in refs[0].values()]


def golden(cell, s, root: str):
    """The program's errors on the bundled recording against the golden 2D
    result, at the result's own limits (configurations that state them)."""
    gc = cell.cfg.get("golden_contract")
    if not gc:
        return None
    with open(os.path.join(root, gc["result"]), "rb") as f:
        result = pickle.load(f)
    _, p38, conf = (t.cpu() for t in s.prog(torch.from_numpy(s.recording).to(s.device)))
    pts_err = float(np.abs(p38.numpy() - result["points2d"]).max())
    conf_err = float(np.abs(conf.numpy() - result["heatmap_confidence"]).max())
    return {"pts_err": pts_err, "pts_tol": gc["pts_tol"], "conf_err": conf_err,
            "conf_tol": gc["conf_tol"],
            "pass": pts_err <= gc["pts_tol"] and conf_err <= gc["conf_tol"]}
