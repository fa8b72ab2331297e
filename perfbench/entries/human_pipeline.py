"""The human 2D->3D call: ``Pipeline.__call__`` of the h36m capture profile on one chunk.

The program is ``build_pipeline(spec, variables, calib, order, rig=None,
device, profile)``: the configuration's ``profile``, its weights as a lab
has them, a checkpoint file (the builder's arrays written to a temporary
``.npz`` and read by the program's own reader), and its rig's calibration
(``utils/synthetic.human_rig`` of the configuration's ``rig``, float32);
no registration.  One call takes a chunk (T, C, H, W, 3) uint8 on the
device and returns (points3d (T, J, 3), points2d (C, T, J, 2), conf (C, T,
J, 1)).  The reference is ``reference/human_pipeline.run``.

The judge gives the ``pipeline`` entry's four numbers (``compare.py``) on
the J joints of every camera, with no assembly: ``conf_err``; ``cell_gap``
(a differing 2D point's cell, (row * h, col * w), read back on the
reference's heatmap; a point off the grid reads infinity); ``p3d_err``
(the program's 2D points undistorted and triangulated by the reference's
float64 DLT, against the program's 3D output, relative, for points whose
equations separate by ``compare.SEPARATION``); ``p3d_resid`` (every point
seen twice or more, its residual above the least over the gap).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict

import numpy as np
import torch

import compare
from reference import human_pipeline as ref

NAMES = compare.NAMES
MAXED = ("mismatched",)
SUMMED = ("seen", "determined")


def _calib(cfg):
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.utils import synthetic

    return geometry.calib_to_arrays(synthetic.human_rig(**cfg["rig"]), cfg["num_cameras"],
                                    dtype=np.float32)


def build(cell, root: str, made: dict, device: torch.device):
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.pipeline import build_pipeline

    cfg = cell.cfg
    if cfg.get("tf32"):
        raise ValueError(f"{cfg['name']}: tf32 true is not honoured: the program computes "
                         "float32 products in full float32")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.npz")
        np.savez(path, **made["checkpoint_arrays"])
        variables, spec = load_weights(path)
    spec = dataclasses.replace(spec, compute_dtype=cfg["dtype"])
    return build_pipeline(spec, variables, _calib(cfg), cfg["camera_ordering"], rig=None,
                          device=device, profile=cfg["profile"])


def reference(cell, pool, made: dict, device, root: str, tf32: bool = False):
    """-> ({chunk: reference/human_pipeline.Result}, rig)."""
    from reference import hourglass

    rig = ref.load_rig(cell.cfg)
    net = hourglass.Hourglass(made["layout"], cell.cfg["spec"], cell.cfg["spec"]["proj_from_raw"])
    hw = tuple(cell.cfg["image_hw"])
    return {k: ref.run(chunk.to(device), net, rig, hw, tf32=tf32)
            for k, chunk in enumerate(pool)}, rig


def _cell_gap(p2d, r: ref.Result):
    """-> (the worst gap over the points that differ from the reference's, their count)."""
    C, T, J, _ = p2d.shape
    hm = r.heatmaps
    h, w = hm.shape[2:]
    c, t, j = np.nonzero(np.abs(p2d - r.points2d).max(axis=-1) > 1e-6)
    if not len(c):
        return 0.0, 0
    row, col = p2d[c, t, j, 0] * h, p2d[c, t, j, 1] * w
    ri, ci = np.rint(row), np.rint(col)
    bad = (np.abs(row - ri) > 1e-3) | (np.abs(col - ci) > 1e-3) \
        | (ri < 0) | (ri >= h) | (ci < 0) | (ci >= w)
    index = [torch.as_tensor(a, device=hm.device) for a in
             (t * C + c, j, np.clip(ri, 0, h - 1).astype(np.int64),
              np.clip(ci, 0, w - 1).astype(np.int64))]
    at = hm[index[0], index[1], index[2], index[3]].double().cpu().numpy()
    top = hm.flatten(2).max(dim=-1).values[index[0], index[1]].double().cpu().numpy()
    return float(np.where(bad, np.inf, top - at).max()), len(c)


def judge(out, r: ref.Result, rig: ref.Rig, image_hw) -> Dict:
    """One call's outputs (points3d, points2d, conf) against the reference's
    result on its chunk: -> {name: number, "mismatched", "seen", "determined"}."""
    p3d, p2d, conf = (np.asarray(a, np.float64) for a in out)
    if (p2d.shape, conf.shape, p3d.shape) != (r.points2d.shape, r.conf.shape, r.points3d.shape) \
            or not all(np.isfinite(a).all() for a in (p3d, p2d, conf)):
        return {**{n: np.inf for n in NAMES}, "mismatched": -1, "seen": 0, "determined": 0}
    gap, mismatched = _cell_gap(p2d, r)
    tri, separation = ref.triangulate(p2d, rig, image_hw)
    norm = np.linalg.norm(tri, axis=-1)
    scale = np.maximum(norm, max(float(np.median(norm[norm > 0])) if (norm > 0).any() else 1.0,
                                 1e-12))
    judged = separation >= compare.SEPARATION
    p3d_err = float((np.linalg.norm(p3d - tri, axis=-1) / scale)[judged].max(initial=0.0))
    seen = np.isfinite(separation)
    resid = ref.residual_excess(p2d, p3d, rig, image_hw)
    return {"conf_err": float(np.abs(conf - r.conf).max()), "cell_gap": gap,
            "p3d_err": p3d_err, "p3d_resid": float(resid.max(initial=0.0)),
            "mismatched": mismatched, "seen": int(seen.sum()),
            "determined": int((seen & judged).sum())}


def judge_call(cell, arrays, refs, k: int) -> Dict:
    results, rig = refs
    return judge(arrays, results[k], rig, tuple(cell.cfg["image_hw"]))


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
    points moved by 1%, one frame's 3D points zeroed, and the 3D points
    triangulated by the program's DLT from the distorted observations (the
    undistortion skipped)."""
    from deepfly3d_torch.ops import geometry

    n = len(outs)
    stale = [outs[(k - 1) % n] for k in range(n)]
    half = []
    for chunk in s.pool:
        T = chunk.shape[0]
        p3d, p2d, conf = (t.cpu() for t in s.prog(chunk[: T // 2]))
        half.append((torch.cat([p3d, p3d], 0)[:T], torch.cat([p2d, p2d], 1)[:, :T],
                     torch.cat([conf, conf], 1)[:, :T]))
    h = cell.cfg["spec"]["input_shape"][0] // 4
    H, W = cell.cfg["image_hw"]
    prog = s.prog
    moved2d, moved3d, zeroed3d, distorted = [], [], [], []
    for p3d, p2d, conf in outs:
        p2d_moved, p3d_moved, p3d_zeroed = p2d.clone(), p3d.clone(), p3d.clone()
        p2d_moved[0, 0, 0, 0] += 1.0 / h
        p3d_moved[0] *= 1.01
        p3d_zeroed[0] = 0.0
        moved2d.append((p3d, p2d_moved, conf))
        moved3d.append((p3d_moved, p2d, conf))
        zeroed3d.append((p3d_zeroed, p2d, conf))
        raw = geometry.triangulate(p2d.to(prog.device), prog.R, prog.tvec, prog.intr, (W, H),
                                   method=prog.dlt)
        distorted.append((raw.cpu(), p2d, conf))
    return {"stale": stale, "half_batch": half, "moved_2d_point": moved2d,
            "moved_3d_frame": moved3d, "zeroed_3d_frame": zeroed3d,
            "undistortion_skipped": distorted}


def control_outputs(refs) -> list:
    """The reference's own results in the program's output layout, per chunk."""
    return [(r.points3d, r.points2d, r.conf) for r in refs[0].values()]


def golden(cell, s, root: str):
    return None
