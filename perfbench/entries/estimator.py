"""The CLI's 2D ingest: ``deepfly3d_torch.models.inference.PoseEstimator.infer_chunks``.

The path ``df3d-cli`` takes (``Core.pose2d_estimation`` -> ``infer_folder`` /
``infer_videos`` -> ``infer_chunks``): the program is ``PoseEstimator(checkpoint,
device, rig_template="auto")`` for a configuration whose builder gives a
checkpoint file.  One call takes one chunk of a recording, (T, C, H, W, 3)
uint8 host numpy as a decoder yields it (the ``host`` pool), lays its images
out camera-major as ``infer_folder`` does, with each image's camera and flip
as ``Core.pose2d_estimation`` sets them (the program's ``flip_cameras`` by
ordering position), runs ``infer_chunks`` at the mix's ``batch_size`` and
returns (points2d (C, T, 19, 2), conf (C, T, 19, 1)) float64, reshaped as
``infer_folder`` reshapes them.  The run is one recording: one registration
cache for every call, filled by the first warm-up call (the host estimate's
seconds fall in set-up), as ``infer_folder`` reuses it for a recording's
later chunks.

The reference is ``reference/ingest.run``.  The judge compares, per image
and joint:

* ``conf_err``: the largest |conf - reference conf|;
* ``cell_gap``: for every point that differs from the reference's, the
  cell the program chose, read back from the point (the reference's shift
  taken off, the column's term negated on a flipped camera; the network's
  frame, flipped where the image was), and how far the reference's heatmap
  there lies below its maximum; a point off the heatmap's grid reads
  infinity.

An output that holds NaN, or has another shape, reads infinity everywhere.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

NAMES = ("conf_err", "cell_gap")
MAXED = ("mismatched",)
SUMMED = ()
SPEC_KEYS = ("num_stacks", "features", "depth", "num_blocks", "num_classes", "stem",
             "input_shape", "proj_from_raw")


class Ingest:
    """One recording's ingest: ``PoseEstimator.infer_chunks`` on each chunk."""

    def __init__(self, est, order, flip_positions, batch_size: int):
        self.est, self.batch_size, self.reg = est, batch_size, {}
        self.flip_ids = [cam for pos, cam in enumerate(order) if pos in flip_positions]

    def __call__(self, chunk: np.ndarray):
        if not isinstance(chunk, np.ndarray):
            raise TypeError("the estimator entry takes host numpy frames (pool 'host')")
        T, C = chunk.shape[:2]
        images = chunk.transpose(1, 0, 2, 3, 4).reshape((C * T,) + chunk.shape[2:])
        cams = np.repeat(np.arange(C), T)
        flip = np.isin(cams, self.flip_ids)
        pts, conf = self.est.infer_chunks([(images, cams, flip)], batch_size=self.batch_size,
                                          registration=self.reg)
        K = pts.shape[1]
        return (pts.reshape(C, T, K, 2).astype(np.float64),
                conf.reshape(C, T, K, 1).astype(np.float64))


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build(cell, root: str, made: dict, device: torch.device) -> Ingest:
    from deepfly3d_torch.config import fly_config
    from deepfly3d_torch.models.inference import PoseEstimator
    from deepfly3d_torch.ops import canonicalize

    cfg = cell.cfg
    if "checkpoint" not in made:
        raise ValueError(f"{cfg['name']}: the estimator entry loads a checkpoint file, and "
                         f"builder {cfg['builder']!r} makes a state dict: convert it first "
                         "(models/convert_torch.convert_checkpoint, then save_weights)")
    found = canonicalize.find_template(made["checkpoint"])
    want = cfg["data_sha256"][cfg["rig_template"]]
    if found is None or _sha256(found) != want:
        raise ValueError(f"{cfg['name']}: rig_template='auto' finds {found}, not the "
                         f"configuration's {cfg['rig_template']}")
    est = PoseEstimator(made["checkpoint"], device=device, rig_template="auto")
    spec = {k: getattr(est.spec, k) for k in SPEC_KEYS}
    spec["input_shape"] = list(est.input_shape)       # the checkpoint's, else the program's default
    if spec != {k: cfg["spec"][k] for k in SPEC_KEYS} or est.spec.compute_dtype != cfg["dtype"] \
            or cfg.get("tf32"):
        raise ValueError(f"{cfg['name']}: the checkpoint's net {spec} in "
                         f"{est.spec.compute_dtype} is not the configuration's")
    return Ingest(est, cfg["camera_ordering"], fly_config().flip_cameras,
                  int(cell.mix["batch_size"]))


def reference(cell, pool, made: dict, device, root: str, tf32: bool = False):
    """-> ({chunk: reference/ingest.Result}, the recording's registration)."""
    from reference import hourglass, ingest
    from reference import pipeline as ref

    rig = ref.load_rig(cell.cfg, root)
    net = hourglass.Hourglass(made["layout"], cell.cfg["spec"], cell.cfg["spec"]["proj_from_raw"])
    hw = tuple(cell.cfg["image_hw"])
    frames = [torch.from_numpy(np.asarray(chunk)).to(device) for chunk in pool]
    reg = ingest.register(frames[0], rig)
    return {k: ingest.run(f, net, rig, reg, hw, tf32=tf32)
            for k, f in enumerate(frames)}, (reg, ingest.flipped(rig))


def judge_call(cell, arrays, refs, k: int) -> Dict:
    results, (reg, flip) = refs
    r = results[k]
    pts, conf = (np.asarray(a, np.float64) for a in arrays)
    if (pts.shape, conf.shape) != (r.points2d.shape, r.conf.shape) \
            or not (np.isfinite(pts).all() and np.isfinite(conf).all()):
        return {**{n: np.inf for n in NAMES}, "mismatched": -1}
    gap, mismatched = _cell_gap(pts, r, reg, flip, tuple(cell.cfg["image_hw"]))
    return {"conf_err": float(np.abs(conf - r.conf).max()), "cell_gap": gap,
            "mismatched": mismatched}


def _cell_gap(pts, r, reg, flip, image_hw):
    """-> (the worst gap over the points that differ from the reference's, their count)."""
    C, T, K, _ = pts.shape
    H, W = image_hw
    hm = r.heatmaps
    h, w = hm.shape[2:]
    c, t, j = np.nonzero(np.abs(pts - r.points2d).max(axis=-1) > 1e-6)
    if not len(c):
        return 0.0, 0
    row = (pts[c, t, j, 0] - reg.dy[c] / H) * h
    col = (pts[c, t, j, 1] - np.where(flip[c], -1.0, 1.0) * reg.dx[c] / W) * w
    ri, ci = np.rint(row), np.rint(col)
    bad = (np.abs(row - ri) > 1e-3) | (np.abs(col - ci) > 1e-3) \
        | (ri < 0) | (ri >= h) | (ci < 0) | (ci >= w)
    img = torch.as_tensor(c * T + t, device=hm.device)
    jt = torch.as_tensor(j, device=hm.device)
    at = hm[img, jt, torch.as_tensor(np.clip(ri, 0, h - 1).astype(np.int64), device=hm.device),
            torch.as_tensor(np.clip(ci, 0, w - 1).astype(np.int64), device=hm.device)]
    top = hm.flatten(2).max(dim=-1).values[img, jt]
    gap = (top - at).double().cpu().numpy()
    return float(np.where(bad, np.inf, gap).max()), len(c)


def keep(program: Ingest) -> dict:
    """The program's registration cache: (dy, dx, gain) by camera (empty for a
    wrapped program)."""
    return dict(getattr(program, "reg", {}))


def notes(got: Dict, kept: dict, refs) -> list:
    """What was judged, and the host estimate beside the reference's
    registration, per camera (a report: the judge reads the outputs alone)."""
    reg = refs[1][0]
    want = {c: (int(reg.dy[c]), int(reg.dx[c]), float(reg.gain[c])) for c in range(len(reg.dy))}
    got_reg = {int(c): (int(v[0]), int(v[1]), float(v[2])) for c, v in kept.items()}
    differ = {c: {"program": got_reg.get(c), "reference": v} for c, v in want.items()
              if got_reg.get(c) is None or got_reg[c][:2] != v[:2]
              or abs(got_reg[c][2] - v[2]) > 1e-9 * abs(v[2])}
    agree = (f"the host estimate and the reference's DISAGREE: {differ}" if differ else
             f"the host estimate and the reference's agree on every camera: {want}")
    return [f"points differing from the reference's: {got['mismatched']} at most in a "
            f"call; distinct outputs judged: {got['distinct_outputs']}",
            "registration (dy, dx, gain) by camera: " + agree]


def faults(cell, s, outs) -> Dict[str, list]:
    """The previous chunk's outputs (stale state), half of each camera's frames
    computed and the rest copied from them, one point moved one cell, and the
    gain divided, as the 2D->3D call applies it, where the ingest multiplies."""
    n = len(outs)
    stale = [outs[(k - 1) % n] for k in range(n)]
    half = []
    for chunk in s.pool:
        T = chunk.shape[0]
        pts, conf = s.prog(chunk[: T // 2])
        half.append((np.concatenate([pts, pts], 1)[:, :T], np.concatenate([conf, conf], 1)[:, :T]))
    moved = []
    for pts, conf in outs:
        pts = np.array(pts)
        pts[0, 0, 0, 0] += 4.0 / cell.cfg["spec"]["input_shape"][0]   # a heatmap row: input / 4
        moved.append((pts, conf))
    restore = divide_gain(s.prog)
    try:
        divided = [s.prog(chunk) for chunk in s.pool]
    finally:
        restore()
    return {"stale": stale, "half_batch": half, "moved_point": moved, "gain_divided": divided}


def divide_gain(program: Ingest):
    """Plant the 2D->3D call's gain convention in the program's preprocess:
    the input divided by the measured gain.  -> a function that undoes it."""
    est = program.est
    plain = est.preprocess

    def divided(frames, flip, shape, dtype, shift=None, gain=None):
        return plain(frames, flip, shape, dtype, shift=shift,
                     gain=None if gain is None else 1.0 / gain)

    est.preprocess = divided

    def restore():
        est.preprocess = plain
    return restore


def control_outputs(refs) -> list:
    """The reference's own results in the program's output layout, per chunk."""
    return [(r.points2d, r.conf.astype(np.float64)) for r in refs[0].values()]


def golden(cell, s, root: str):
    return None
