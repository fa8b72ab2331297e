"""Seeded synthetic inputs: a random hourglass checkpoint and a 4-camera recording.

No checkpoint of the 128-wide h36m network ships, and none is downloaded:
its runs, on the card and in the tests, take weights and frames made here
from a seed, in numpy alone (no torch, no JAX), so that both packages read
the same bytes.

* ``random_checkpoint`` writes the flat ``.npz`` of
  ``deepfly3d_tpu/models/hourglass.py::save_weights`` (the flax variable
  paths and the ``__spec__/*`` fields) for a conv-stem ``HourglassSpec``.
  The batch norms get non-zero means and biases and variances away from 1
  (flax's initialisation, zero and one, would hide faults that only show
  where a fold's shift is not zero), and the convolutions are scaled so
  that activations stay within ~50 through four stacks of residual blocks
  (the hourglass's merges add their branches; the trained fly checkpoint's
  reach ~400) and the heatmaps' peaks at ~2 (the fly checkpoint's: ~0.9),
  with top-2 margins of ~0.005 (the noise floor gives the trunk's full-width
  branch its detail).
* ``torch_state_dict`` lays such arrays out under the canonical torch
  stacked-hourglass names that ``models/convert_torch`` maps (the df2d sh8
  lineage): a seeded stand-in for a torch checkpoint, which the repository
  does not hold, at the converter's default spec (256 features).
* ``human_rig`` / ``human_frames``: a human-scale 17-joint skeleton moving
  slightly over T frames, seen by cameras 90 degrees apart around it with
  barrel distortion, drawn as one Gaussian blob per joint over a noise
  floor (the scenes of the JAX package's h36m tests, at the size of a
  Human3.6M frame).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# H3.6M-like rest pose in meters, pelvis at the origin, image-down = +y
# (joint order of skeletons/h36m.py)
_POSE = np.array([
    [0.00, 0.00, 0.00], [-0.13, 0.00, 0.00], [-0.13, 0.45, 0.02], [-0.13, 0.88, 0.00],
    [0.13, 0.00, 0.00], [0.13, 0.45, 0.02], [0.13, 0.88, 0.00],
    [0.00, -0.25, 0.00], [0.00, -0.50, 0.00], [0.00, -0.60, 0.00], [0.00, -0.75, 0.02],
    [0.18, -0.50, 0.00], [0.26, -0.26, 0.06], [0.30, -0.03, 0.12],
    [-0.18, -0.50, 0.00], [-0.26, -0.26, 0.06], [-0.30, -0.03, 0.12],
])


def _block_names(num_stacks: int, depth: int, num_blocks: int) -> List[str]:
    names = ["stem_res1", "stem_res2", "stem_res3"]

    def walk(prefix: str, d: int):
        for kind in ("skip", "down"):
            names.extend(f"{prefix}/{kind}_d{d}_{i}" for i in range(num_blocks))
        if d > 1:
            walk(prefix, d - 1)
        else:
            names.extend(f"{prefix}/innermost_{i}" for i in range(num_blocks))
        names.extend(f"{prefix}/up_d{d}_{i}" for i in range(num_blocks))

    for s in range(num_stacks):
        walk(f"hg{s}", depth)
        names.append(f"feat_res{s}")
    return names


def random_checkpoint(path: str, seed: int, num_stacks: int, features: int, depth: int,
                      num_classes: int, input_shape: Tuple[int, int], num_blocks: int = 1,
                      expansion: int = 2) -> Dict[str, np.ndarray]:
    """Write a random conv-stem hourglass checkpoint to ``path``; -> its arrays.

    Every float32 array is drawn from ``numpy.random.default_rng(seed)`` in
    the order the keys are listed, so the file depends on the seed and the
    spec alone.
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    F, mid = features, features // expansion

    def conv(name, k, cin, cout, gain=1.0):
        std = gain / np.sqrt(k * k * cin)
        out[f"params/{name}/kernel"] = (rng.standard_normal((k, k, cin, cout)) * std)
        out[f"params/{name}/bias"] = rng.standard_normal(cout) * 0.05

    def bn(name, c):
        out[f"params/{name}/scale"] = rng.uniform(0.8, 1.2, c)
        out[f"params/{name}/bias"] = rng.standard_normal(c) * 0.1
        out[f"batch_stats/{name}/mean"] = rng.standard_normal(c) * 0.1
        out[f"batch_stats/{name}/var"] = rng.uniform(0.5, 1.5, c)

    def block(name, cin):
        bn(f"{name}/bn1", cin)
        conv(f"{name}/conv1", 1, cin, mid, gain=np.sqrt(2.0))
        bn(f"{name}/bn2", mid)
        conv(f"{name}/conv2", 3, mid, mid, gain=np.sqrt(2.0))
        bn(f"{name}/bn3", mid)
        conv(f"{name}/conv3", 1, mid, F, gain=0.3)       # small residual steps
        if cin != F:
            conv(f"{name}/proj", 1, cin, F)

    conv("stem_conv", 7, 3, F // 2, gain=2.0)
    bn("stem_bn", F // 2)
    for name in _block_names(num_stacks, depth, num_blocks):
        block(name, F // 2 if name == "stem_res1" else F)
        stack = name[len("feat_res"):] if name.startswith("feat_res") else None
        if stack is not None:
            i = int(stack)
            conv(f"feat_conv{i}", 1, F, F, gain=np.sqrt(2.0))
            bn(f"feat_bn{i}", F)
            conv(f"score{i}", 1, F, num_classes, gain=0.06)  # peaks ~2: a trained net's scale
            if i < num_stacks - 1:
                conv(f"remap_feat{i}", 1, F, F, gain=0.1)      # no growth over stacks
                conv(f"remap_score{i}", 1, num_classes, F, gain=0.1)
    arrays = {k: np.asarray(v, np.float32) for k, v in out.items()}
    meta = {
        "__spec__/num_stacks": num_stacks, "__spec__/features": features,
        "__spec__/depth": depth, "__spec__/num_blocks": num_blocks,
        "__spec__/num_classes": num_classes, "__spec__/expansion": expansion,
        "__spec__/bn_momentum": 0.99, "__spec__/stem": "conv", "__spec__/head_upsample": 1,
        "__spec__/input_shape": np.asarray(input_shape, np.int64),
    }
    np.savez(path, **arrays, **{k: np.asarray(v) for k, v in meta.items()})
    return arrays


def torch_state_dict(arrays: Dict[str, np.ndarray], num_stacks: int,
                     depth: int) -> Dict[str, np.ndarray]:
    """``random_checkpoint``'s arrays (one block per level) as a torch state
    dict of the canonical stacked hourglass, numpy arrays under the names that
    ``models/convert_torch.convert_state_dict`` maps back: ``conv1`` / ``bn1``,
    ``layer{1,2,3}.0``, ``hg.{s}.hg.{level}.{slot}.0`` (levels innermost
    first, slot 3 the innermost block), ``res.{s}.0``, ``fc.{s}.0`` /
    ``fc.{s}.1``, ``score.{s}``, ``fc_.{s}`` and ``score_.{s}``; kernels OIHW,
    batch norms as weight, bias, running_mean and running_var."""
    sd: Dict[str, np.ndarray] = {}

    def conv(flax: str, name: str):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            arrays[f"params/{flax}/kernel"].transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = arrays[f"params/{flax}/bias"]

    def bn(flax: str, name: str):
        sd[f"{name}.weight"] = arrays[f"params/{flax}/scale"]
        sd[f"{name}.bias"] = arrays[f"params/{flax}/bias"]
        sd[f"{name}.running_mean"] = arrays[f"batch_stats/{flax}/mean"]
        sd[f"{name}.running_var"] = arrays[f"batch_stats/{flax}/var"]

    def block(flax: str, name: str):
        for i in (1, 2, 3):
            bn(f"{flax}/bn{i}", f"{name}.bn{i}")
            conv(f"{flax}/conv{i}", f"{name}.conv{i}")
        if f"params/{flax}/proj/kernel" in arrays:
            conv(f"{flax}/proj", f"{name}.downsample.0")

    conv("stem_conv", "conv1")
    bn("stem_bn", "bn1")
    for i, name in enumerate(("stem_res1", "stem_res2", "stem_res3"), start=1):
        block(name, f"layer{i}.0")
    for s in range(num_stacks):
        for level in range(depth):
            d = level + 1
            slots = {0: f"hg{s}/skip_d{d}_0", 1: f"hg{s}/down_d{d}_0", 2: f"hg{s}/up_d{d}_0"}
            if d == 1:
                slots[3] = f"hg{s}/innermost_0"
            for slot, flax in slots.items():
                block(flax, f"hg.{s}.hg.{level}.{slot}.0")
        block(f"feat_res{s}", f"res.{s}.0")
        conv(f"feat_conv{s}", f"fc.{s}.0")
        bn(f"feat_bn{s}", f"fc.{s}.1")
        conv(f"score{s}", f"score.{s}")
        if s < num_stacks - 1:
            conv(f"remap_feat{s}", f"fc_.{s}")
            conv(f"remap_score{s}", f"score_.{s}")
    return sd


def _rot_y(theta: float) -> np.ndarray:
    """Rotation by ``theta`` about the y axis (Rodrigues of (0, theta, 0))."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def human_rig(num_cameras: int = 4, size: int = 1000, focal: float = 1400.0,
              distance: float = 5.0, k1: float = -0.15) -> Dict[int, Dict[str, np.ndarray]]:
    """{camera: {R, tvec, intr, distort}}: cameras 90 degrees apart around the
    origin at ``distance``, square ``size`` frames, barrel distortion k1
    (the calibration-prior format of ``Core``)."""
    K = np.array([[focal, 0.0, size / 2.0], [0.0, focal, size / 2.0], [0.0, 0.0, 1.0]])
    dist = np.zeros(5)
    dist[0] = k1
    return {c: {"R": _rot_y(np.pi / 2 * c), "tvec": np.array([0.0, 0.0, distance]),
                "intr": K.copy(), "distort": dist.copy()} for c in range(num_cameras)}


def project(points: np.ndarray, cam: Dict[str, np.ndarray]) -> np.ndarray:
    """(..., 3) world points -> (..., 2) pixel (x, y) through one camera of
    ``human_rig`` (radial and tangential distortion, OpenCV's model)."""
    Xc = points @ cam["R"].T + cam["tvec"]
    x, y = Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2]
    k1, k2, p1, p2, k3 = cam["distort"]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    K = cam["intr"]
    return np.stack([K[0, 0] * xd + K[0, 1] * yd + K[0, 2], K[1, 1] * yd + K[1, 2]], axis=-1)


def human_frames(seed: int, num_frames: int, rig: Dict[int, Dict[str, np.ndarray]],
                 size: int = 1000, sigma: float = 9.0, noise: int = 64):
    """-> (frames (C, T, size, size, 3) uint8, points3d (T, 17, 3), pixels (C, T, 17, 2)).

    The rest pose drifts and jitters over the frames; joint j is a Gaussian
    blob of ``sigma`` pixels in colour channel j % 3, over uniform noise in
    [0, noise).
    """
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.standard_normal((num_frames, 1, 3)) * 0.02, axis=0)
    points3d = _POSE[None] + drift + rng.standard_normal((num_frames, len(_POSE), 3)) * 0.02
    C = len(rig)
    pixels = np.stack([project(points3d, rig[c]) for c in range(C)])
    frames = rng.integers(0, noise, size=(C, num_frames, size, size, 3)).astype(np.float32)
    r = int(np.ceil(4 * sigma))
    for c in range(C):
        for t in range(num_frames):
            for j, (px, py) in enumerate(pixels[c, t]):
                x0, y0 = int(round(px)), int(round(py))
                ys = np.arange(max(0, y0 - r), min(size, y0 + r + 1))
                xs = np.arange(max(0, x0 - r), min(size, x0 + r + 1))
                blob = np.exp(-((ys[:, None] - py) ** 2 + (xs[None, :] - px) ** 2)
                              / (2 * sigma ** 2))
                frames[c, t, ys[:, None], xs[None, :], j % 3] += 230.0 * blob
    return np.clip(np.rint(frames), 0, 255).astype(np.uint8), points3d, pixels


def write_jpegs(folder: str, frames: np.ndarray) -> List[str]:
    """(C, T, H, W, 3) RGB uint8 -> ``folder/camera_{c}_img_{t}.jpg`` (OpenCV);
    -> the paths, camera-major."""
    import os

    import cv2

    os.makedirs(folder, exist_ok=True)
    paths = []
    for c in range(frames.shape[0]):
        for t in range(frames.shape[1]):
            path = os.path.join(folder, f"camera_{c}_img_{t}.jpg")
            if not cv2.imwrite(path, cv2.cvtColor(frames[c, t], cv2.COLOR_RGB2BGR)):
                raise IOError(f"cv2.imwrite failed for {path}")
            paths.append(path)
    return paths


def main(argv=None) -> int:
    """``python -m deepfly3d_torch.utils.synthetic OUT [--frames T] [--seed S]``:
    a seeded h36m recording for ``--profile h36m``: ``OUT/images`` (4 cameras
    of 1000x1000 JPEGs), ``OUT/calib_prior.pkl`` and the full-width random
    checkpoint ``OUT/hourglass_h36m_seed{S}.npz``."""
    import argparse
    import os
    import pickle

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rig = human_rig()
    frames, _, _ = human_frames(args.seed, args.frames, rig)
    write_jpegs(os.path.join(args.out, "images"), frames)
    with open(os.path.join(args.out, "calib_prior.pkl"), "wb") as fh:
        pickle.dump(rig, fh)
    ckpt = os.path.join(args.out, f"hourglass_h36m_seed{args.seed}.npz")
    random_checkpoint(ckpt, args.seed, num_stacks=4, features=128, depth=4, num_classes=17,
                      input_shape=(384, 384))
    print(f"python -m deepfly3d_torch.cli {os.path.join(args.out, 'images')} --profile h36m "
          f"--calib-prior {os.path.join(args.out, 'calib_prior.pkl')} --checkpoint {ckpt} "
          f"--solver lm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
