"""The golden contract, the held-out probes and the timing harness for the port's pipelines.

Counterpart of ``bench.py:189-447`` (the JAX package's benchmark harness)
for ``pipeline.build_pipeline`` / ``models/cascade.build_cascade_pipeline``
objects; the JAX script's ``main`` (its benchmark run over the TPU rounds'
configurations) is not part of it:

* ``load_golden_frames``: the bundled recording, (15, 7, 480, 960, 3) uint8,
  and the golden pickle;
* ``verify_contract``: a pipeline's errors against the golden 2D result,
  points within 0.02 and confidence within 0.002;
* ``load_probe_frames`` / ``verify_probes``: the six held-out probes built
  as JAX builds them (the bundled mp4s expanded to JPEGs, JPEG quality 90,
  +-2 px rolls, 0.95 / 1.05 gains), each with its gate;
* ``measure_fps``: frames/s of a pipeline on random frames made on the
  device, between two ``torch.cuda.synchronize``;
* ``forward_flops`` / ``pipeline_flops`` / ``pipeline_mfu``: the FLOPs of a
  pipeline counted from its specs, and their rate as a share of the card's
  peak for the path's arithmetic (an H100's, never a TPU's);
* ``bench_bundle_adjust``: both bundle-adjustment solvers on the golden 2D
  result, on the host.

    python -m deepfly3d_torch.bench [--device cpu]   # contract, probes, frames/s of conv

The JAX functions' silent fallbacks are kept: ``load_probe_frames`` leaves
out ``reencode`` when the expanded JPEGs are missing.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

NUM_CAMERAS = 7
IMAGE_H, IMAGE_W = 480, 960
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hourglass_fly.npz")
GOLDEN_2D = os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl")
REFERENCE = os.path.join(ROOT, "tests", "data", "reference")
GOLDEN_T = 15
PTS_TOL, CONF_TOL = 0.02, 0.002            # the reference's contract

# published dense peaks of one H100 SXM: float32 on the CUDA cores, bf16 on
# the tensor cores (the TF32 rate, 495e12, is what the bottleneck kernel's
# 3xTF32 products run at; the FLOPs counted here are the model's own)
H100_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
H100 = "NVIDIA H100 SXM (dense)"


# ------------------------------------------------------------ the contract


def load_golden_frames():
    """The golden recording as (15, 7, 480, 960, 3) uint8 and the golden pickle."""
    from deepfly3d_torch.models.inference import _read_images_threaded

    with open(GOLDEN_2D, "rb") as f:
        golden = pickle.load(f)
    paths = [os.path.join(REFERENCE, f"camera_{cam}_img_{t}.jpg")
             for t in range(GOLDEN_T) for cam in range(NUM_CAMERAS)]
    frames = _read_images_threaded(paths).reshape(GOLDEN_T, NUM_CAMERAS, IMAGE_H, IMAGE_W, 3)
    return frames, golden


def verify_contract(pipeline, golden_frames, golden):
    """Run ``golden_frames`` through ``pipeline``: -> (pts_err, conf_err,
    passes) against the golden 2D result and the reference's tolerances."""
    _, p38, conf = pipeline(golden_frames)
    pts_err = float(np.abs(p38.cpu().numpy() - golden["points2d"]).max())
    conf_err = float(np.abs(conf.cpu().numpy() - golden["heatmap_confidence"]).max())
    return pts_err, conf_err, (pts_err <= PTS_TOL and conf_err <= CONF_TOL)


def load_probe_frames():
    """The held-out probes: -> {name: (frames (15, 7, 480, 960, 3) uint8,
    pts_tol, conf_tol or None)}.

    * ``reencode``: the 7 bundled mp4s expanded back to JPEGs
      (``io/discovery.expand_videos``), gated at pts 0.02 and conf 0.006;
      left out when the expanded JPEGs are missing, as in JAX;
    * ``jpeg_q90``: the golden JPEGs re-encoded by OpenCV at quality 90,
      gated on points (0.02);
    * ``shift-2px`` / ``shift+2px``: the golden frames rolled by 2 px along
      the width, gated on points at 0.02 + 2/960;
    * ``gain0.95`` / ``gain1.05``: float32 multiply, clip to [0, 255],
      uint8; gated on points (0.02).
    """
    import cv2

    from deepfly3d_torch.io import discovery
    from deepfly3d_torch.models.inference import _read_images_threaded

    probes = {}
    tmp = tempfile.mkdtemp(prefix="df3d_probe_")
    try:
        for cam in range(NUM_CAMERAS):
            shutil.copy(os.path.join(REFERENCE, f"camera_{cam}.mp4"), tmp)
        discovery.expand_videos(tmp)
        paths = [os.path.join(tmp, f"camera_{cam}_img_{t}.jpg")
                 for t in range(GOLDEN_T) for cam in range(NUM_CAMERAS)]
        if all(os.path.exists(p) for p in paths):
            frames = _read_images_threaded(paths).reshape(
                GOLDEN_T, NUM_CAMERAS, IMAGE_H, IMAGE_W, 3)
            probes["reencode"] = (frames, 0.02, 0.006)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    golden_frames, _ = load_golden_frames()
    q90 = np.stack([
        cv2.imdecode(cv2.imencode(".jpg", im[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])[1],
                     cv2.IMREAD_COLOR)[:, :, ::-1]
        for im in golden_frames.reshape(-1, IMAGE_H, IMAGE_W, 3)
    ]).reshape(GOLDEN_T, NUM_CAMERAS, IMAGE_H, IMAGE_W, 3)
    probes["jpeg_q90"] = (q90, 0.02, None)
    for dx in (-2, 2):                          # width is axis 3 of (T, C, H, W, 3)
        probes[f"shift{dx:+d}px"] = (np.roll(golden_frames, dx, axis=3),
                                     0.02 + abs(dx) / 960.0, None)
    for gain in (0.95, 1.05):
        probes[f"gain{gain}"] = (
            np.clip(golden_frames.astype(np.float32) * gain, 0, 255).astype(np.uint8),
            0.02, None)
    return probes


def verify_probes(pipeline, probes, golden):
    """Run every probe: -> ({name: {"pts_err", "conf_err" (5 decimals), "pass"}}, all_pass)."""
    report = {}
    all_pass = True
    for name, (frames, pts_tol, conf_tol) in probes.items():
        pts_err, conf_err, _ = verify_contract(pipeline, frames, golden)
        ok = pts_err <= pts_tol and (conf_tol is None or conf_err <= conf_tol)
        report[name] = {"pts_err": round(pts_err, 5), "conf_err": round(conf_err, 5),
                        "pass": ok}
        all_pass = all_pass and ok
    return report, all_pass


# ------------------------------------------------------------------ timing


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fps(pipeline, T: int, iters: Optional[int] = None, seed: int = 0):
    """Frames/s of ``pipeline`` on T random frames of 7 cameras, made on its
    device from a ``torch.Generator`` seeded with ``seed`` (uint8 in [0,
    255), as JAX draws them): one warm-up call, then ``iters`` calls
    (``DF3D_BENCH_ITERS``, default 6) between two synchronizations.
    -> (fps, frames, iters, seconds)."""
    iters = iters or int(os.environ.get("DF3D_BENCH_ITERS", "6"))
    dev = pipeline.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randint(0, 255, (T, NUM_CAMERAS, IMAGE_H, IMAGE_W, 3), dtype=torch.uint8,
                           generator=gen, device=dev)
    pipeline(frames)                            # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        pipeline(frames)
    _sync(dev)
    dt = time.perf_counter() - t0
    return T * iters / dt, frames, iters, dt


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def block_flops(h: int, w: int, cin: int, cout: int) -> int:
    """Multiply-add FLOPs (2 per product) of one bottleneck at h x w: 1x1
    cin->mid, 3x3 mid->mid, 1x1 mid->cout and, where the widths differ, the
    1x1 projection cin->cout (mid = cout // 2)."""
    mid = cout // 2
    macs = cin * mid + 9 * mid * mid + mid * cout + (cin * cout if cin != cout else 0)
    return 2 * h * w * macs


def forward_flops(spec, n: int, input_shape) -> Dict[str, int]:
    """The FLOPs of one folded forward (``FoldedHourglass``) of ``n`` images
    at ``input_shape``, counted from the spec: -> {"stem", "blocks", "heads",
    "adds", "total"}.

    "stem", "blocks" and "heads" are the convolutions and matmuls (2 FLOPs
    per multiply-add: the stem convolution or patch embedding, every
    residual block, and per stack the feature, score and re-injection
    products); they are what ``torch.utils.flop_counter`` counts over the
    plain forward.  "adds" are the merges' and re-injections' element-wise
    additions (1 FLOP per output element).  Batch norms are folded; biases,
    ReLUs and pools are not counted.
    """
    h, w = input_shape
    f, nb, K, u, k = (spec.features, spec.num_blocks, spec.num_classes, spec.head_upsample,
                      spec.score_ksize)
    out = {"stem": 0, "blocks": 0, "heads": 0, "adds": 0}
    if spec.stem == "conv":
        h2, w2 = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
        out["stem"] = 2 * h2 * w2 * 49 * 3 * (f // 2)
        out["blocks"] += block_flops(h2, w2, f // 2, f)
        th, tw = h2 // 2, w2 // 2
    elif spec.stem == "patchify":
        th, tw = h // 4, w // 4
        out["stem"] = 2 * th * tw * 48 * f
    else:
        ks, stride, pad = {"patch16": (16, 8, 4), "patch8": (8, 4, 2)}[spec.stem]
        th, tw = _conv_out(h, ks, stride, pad), _conv_out(w, ks, stride, pad)
        out["stem"] = 2 * th * tw * ks * ks * 3 * f
    out["blocks"] += 2 * block_flops(th, tw, f, f)

    def level(hh, ww, d):
        fl = 2 * nb * block_flops(hh // 2, ww // 2, f, f)       # down, up
        fl += nb * block_flops(hh, ww, f, f)                     # skip
        inner = level(hh // 2, ww // 2, d - 1) if d > 1 else \
            (nb * block_flops(hh // 2, ww // 2, f, f), 0)
        return fl + inner[0], inner[1] + hh * ww * f             # merge: one add per element

    for s in range(spec.num_stacks):
        blocks, adds = level(th, tw, spec.depth)
        out["blocks"] += blocks + block_flops(th, tw, f, f)      # the hourglass, feat_res
        out["adds"] += adds
        heads = f * f + k * k * f * K * u * u                    # feat, score
        if s < spec.num_stacks - 1:
            heads += f * f + K * u * u * f                       # remap_feat, remap_score
            out["adds"] += 2 * th * tw * f
        out["heads"] += 2 * th * tw * heads
    out = {key: v * n for key, v in out.items()}
    out["total"] = sum(out.values())
    return out


def preprocess_flops(n: int, image_hw, out_shape) -> int:
    """The preprocess kernel's arithmetic for ``n`` frames: the separable
    resize's taps (``ops/image.resize_taps``), 2 FLOPs each, over 3 channels:
    the H pass at the input width, the W pass at the output size."""
    from deepfly3d_torch.ops.image import resize_taps

    (h_in, w_in), (h_out, w_out) = image_hw, out_shape
    kh = resize_taps(h_in, h_out)[1].shape[1]
    kw = resize_taps(w_in, w_out)[1].shape[1]
    return 2 * 3 * n * (h_out * w_in * kh + h_out * w_out * kw)


def pipeline_flops(pipeline, T: int) -> Dict[str, int]:
    """FLOPs of one call of a pipeline (or a cascade) on T frames: every net
    it runs (``forward_flops``) and the preprocess of their images; the
    registration, decode, assembly and triangulation are left out (less than
    1e-4 of the total).  A cascade's teacher counts its ``repair_frac``
    share of the images.  -> {"forward", "preprocess", "total"}."""
    n = T * pipeline.num_cameras
    runs = [(pipeline.net, n, pipeline.input_shape)]
    if hasattr(pipeline, "teacher"):
        r = max(int(math.ceil(pipeline.cfg.repair_frac * n)), 1)
        runs.append((pipeline.teacher, r, pipeline.teacher_shape))
    fwd = sum(forward_flops(net.spec, m, shape)["total"] for net, m, shape in runs)
    pre = sum(preprocess_flops(m, pipeline.image_hw, shape) for _, m, shape in runs)
    return {"forward": fwd, "preprocess": pre, "total": fwd + pre}


def pipeline_mfu(pipeline, frames, iters: int, dt: float) -> dict:
    """The share of the card's peak that ``iters`` calls on ``frames`` in
    ``dt`` seconds reach: ``pipeline_flops`` over the H100's dense peak for
    the path's arithmetic (``H100_PEAK_FLOPS`` by the trunk's compute dtype;
    the JAX harness divided by a TPU's 181 TFLOP/s).  -> {"mfu", "flops"
    (per call), "peak_flops", "peak_of", "card", "arithmetic"}."""
    arithmetic = pipeline.net.spec.compute_dtype
    flops = pipeline_flops(pipeline, frames.shape[0])["total"]
    peak = H100_PEAK_FLOPS[arithmetic]
    dev = pipeline.device
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"mfu": flops * iters / dt / peak, "flops": flops, "peak_flops": peak,
            "peak_of": H100, "card": card, "arithmetic": arithmetic}


def bench_bundle_adjust(n_samples: Optional[int] = None):
    """Both solvers (``lm``, ``parity``) on the golden 2D result (7 cameras x
    15 frames x 38 joints) on the host: one warm-up (its cost must fall),
    then ``DF3D_BENCH_BA_SAMPLES`` (default 7) timed runs.
    -> {solver: (median ms, interquartile range ms)}.  Raises RuntimeError
    when a solver's cost does not fall."""
    from deepfly3d_torch.ops import bundle_adjust as ba_mod

    with open(GOLDEN_2D, "rb") as f:
        golden = pickle.load(f)
    with open(os.path.join(ROOT, "data", "calib.pkl"), "rb") as f:
        prior = pickle.load(f)
    prior = {cidx: prior[idx] for idx, cidx in enumerate(golden["camera_ordering"])}
    pts = golden["points2d"]
    n_samples = n_samples or int(os.environ.get("DF3D_BENCH_BA_SAMPLES", "7"))
    timings = {}
    for solver in ("lm", "parity"):
        def run():
            return ba_mod.bundle_adjust(pts, prior, (IMAGE_W, IMAGE_H), solver=solver)

        res = run()
        if not res.cost_final < res.cost_initial:
            raise RuntimeError(f"bundle adjustment ({solver}): the cost did not fall "
                               f"({res.cost_initial} -> {res.cost_final})")
        samples = []
        for _ in range(n_samples):
            t0 = time.perf_counter()
            run()
            samples.append((time.perf_counter() - t0) * 1e3)
        timings[solver] = (float(np.median(samples)),
                           float(np.percentile(samples, 75) - np.percentile(samples, 25)))
    return timings


def main(argv=None) -> int:
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=WEIGHTS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=8, help="T of the frames/s batch")
    args = ap.parse_args(argv)
    variables, spec = load_weights(args.checkpoint)
    with open(os.path.join(ROOT, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), NUM_CAMERAS, dtype=np.float32)
    frames, golden = load_golden_frames()
    pipe = build_pipeline(spec, variables, calib, golden["camera_ordering"], device=args.device)
    pts_err, conf_err, ok = verify_contract(pipe, frames, golden)
    print(f"golden contract: pts_err {pts_err} conf_err {conf_err} "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    report, all_pass = verify_probes(pipe, load_probe_frames(), golden)
    print(f"probes {'PASS' if all_pass else 'FAIL'}: {report}", flush=True)
    fps, x, iters, dt = measure_fps(pipe, args.frames)
    print(f"frames/s {fps} at T={args.frames}; {pipeline_mfu(pipe, x, iters, dt)}", flush=True)
    return 0 if ok and all_pass else 1


if __name__ == "__main__":
    raise SystemExit(main())
