#!/usr/bin/env python3
"""Drive the PyTorch port's inference paths and its CLI on one CUDA card.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --profile FILE   # also a torch.profiler table per path

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. the card's name and power limit, torch and CUDA versions, and the host
   probe: whether OpenCV imports, whether the native ingest library loads,
   and whether the libjpeg and libav headers are there;
2. build the four CUDA kernels from ``deepfly3d_torch/ops/csrc``;
3. the three main paths at full width, T=8 frames (56 images of 480x960,
   rig registration on): ``conv`` (``build_pipeline`` with the shipped
   2-stack f96 ``hourglass_fly.npz``), ``p16`` (``hourglass_fly_p16_tpu.npz``,
   patch16 stem, 3x3 subpixel head) and ``cascade``
   (``build_cascade_pipeline``: student ``hourglass_fly_fast_nearparity.npz``
   at 192x384 on every image, teacher ``hourglass_fly.npz`` on the 7 most
   suspicious), and the CLI's path ``ingest`` (``PoseEstimator.infer_chunks``,
   the loop of ``infer_folder`` / ``infer_videos``, at batch 8 with the conv
   checkpoint over 16 drifted frames per camera).  Each path's plain twin
   (``pipeline.plain_twin``) runs once with recording wrappers: every shape
   the path gives each kernel, and how many times;
4. kernel phase: every kernel against its plain PyTorch version on the card
   at every recorded shape, with the tolerance stated (and the preprocess
   kernel in identity mode at 480x960, which is the TPU kernel exactly).  The
   preprocess runs as the paths run it, with the rig registration's
   per-image shift and gain: it must equal, bit for bit, the kernel on
   ``apply_shift_tc``'s frames times the gain (``unfused_ms`` times that
   composition), and its plain version within the tolerance;
   kernel and one-library-call times from a replayed CUDA graph of 10 calls
   (``ms``, ``library_ms``: device time alone, no host work between the
   launches) and by CUDA events around eager calls (``eager_ms``,
   ``library_eager_ms``, and the plain version's ``plain_ms``: the Python
   wrapper's host work included, which decides at small shapes); the least
   time the card could take (``bound_ms``) from the shapes.  The bottleneck
   kernel is also held against its arithmetic model
   (``bottleneck_tf32_model``), and its ``bound_ms`` is that of the
   arithmetic it runs (three TF32 MMAs per product) with the f32 CUDA-core
   bound beside it (``bound_f32_ms``); the decode also runs a shape whose
   K x cells is no multiple of 4;
5. slice phase: each path once with every launch count set to 0 just
   before and read just after (they must equal the recorded counts); its
   output against its plain twin on the card; frames/s in turns
   (informational).  Then one conv call on drifted frames (per-camera rolls
   and a gain planted on the same frames): the registration must find the
   planted rolls and a gain other than 1, and the output must match the
   plain twin.  With ``--profile FILE``, a torch.profiler table per path and
   its device time, with the time in ``index`` gathers;
   Then the ingest phase: the estimator's chunk loop with every launch
   count set to 0 just before (1 preprocess, 31 bottleneck, 8 upsample-add
   and 1 decode launch per batch), the registration against the planted
   rolls and gains, the output against the plain twin and against the JAX
   package's (``deepfly3d_torch/data/ingest_t16.npz``), frames/s
   (informational).  Then the soft-argmax decode on the ingest heatmaps, on
   the card against a CPU copy, with the device time of its refinement beside
   the decode kernel's;
6. golden phase: golden frame 0 (rig off) through every shipped checkpoint
   and the cascade against the JAX package's output on it
   (``deepfly3d_torch/data/golden_t0.npz``, ``golden_t0_checkpoints.npz``),
   and the golden contract for ``hourglass_fly.npz``;
7. core phase (it fails where no JPEG decoder loads): ``cli.main`` over a
   copy of ``tests/data/reference`` on the card, held to the golden
   contract, and again with ``--soft-argmax --solver lm`` against the JAX
   package's results (``deepfly3d_torch/data/options_t15.npz``); a Core
   seeded with golden 2D through the parity calibration chain, held to the
   golden 3D result, and through the lm chain (plain and Huber) against JAX's;
   ``Core.solve_pictorial`` on frames 0-1 against JAX's; each network run
   with every launch count set to 0 just before (1 preprocess, 31
   bottleneck, 8 upsample-add and 1 decode launch per batch); the StageTimer
   reports and the host decode time;
8. h36m phase: the 4-camera human profile's 4-stack 128-wide network
   (weights from a seed, ``utils/synthetic``; the bottleneck kernel's
   streamed-w2 instances) over 8 seeded frames of 4 cameras of 1000x1000:
   (e) the estimator's chunk loop at batch 8 (1 preprocess, 59 bottleneck,
   16 upsample-add and 1 decode launch per batch) against the JAX package's
   results (``deepfly3d_torch/data/h36m_t4.npz``: conf within 2e-5, the same
   cells outside near-ties, their count printed), frames/s and device ms per
   batch; (f) ``cli.main --profile h36m --solver lm`` over the frames written
   as JPEGs, with a checkpoint in a folder without a rig template: a finite
   4-camera 17-joint result whose 2D equals the port's own ingest of the
   decoded JPEGs on the card.  Its kernel shapes join the kernel phase;
9. video phase: whether ``cv2.VideoWriter`` opens with mp4v, then ``cli.main
   --skip-pose-estimation --video-2d --video-3d`` over a copy of the bundled
   recording seeded with the golden result: both mp4s open with the expected
   frame count and size; the video2d and video3d stage seconds.

Then one JSON line with every kernel's numbers and, last, the device line.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): f32 on the CUDA cores, TF32 on the
# tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

BATCH_T = 8                      # frames of 7 cameras in the slice phase
CONV, P16, STUDENT = "hourglass_fly.npz", "hourglass_fly_p16_tpu.npz", \
    "hourglass_fly_fast_nearparity.npz"
SHIPPED = [CONV, "hourglass_fly_tpu.npz", "hourglass_fly_p16.npz", P16, STUDENT]
# launches of one call of each path at T=8 (the cascade's teacher runs on
# ceil(0.125 * 56) = 7 images)
EXPECTED = {
    "conv": {"fused_bottleneck": 31, "upsample2x_add": 8, "decode_heatmaps": 1,
             "preprocess_resize": 1},
    "p16": {"fused_bottleneck": 16, "upsample2x_add": 4, "decode_heatmaps": 1,
            "preprocess_resize": 1},
    "cascade": {"fused_bottleneck": 16 + 31, "upsample2x_add": 4 + 8, "decode_heatmaps": 2,
                "preprocess_resize": 2},
}
# of the output's largest magnitude: the bottleneck kernel's 3xTF32 products
# against f32 sums in another order, and against its own arithmetic model
BLOCK_TOL = 5e-5
PREPROCESS_TOL = 2e-6   # outputs in [0, 1] times the gain, <= 25 products summed in another order
# planted on the slice phase's frames for the drifted conv call: per-camera
# rolls (rows, columns) and one gain
DRIFT_DY, DRIFT_DX, DRIFT_GAIN = [3, -5, 0, 8, -2, 6, -8], [-4, 7, 2, 0, -8, 5, 1], 1.06
# the ingest phase: golden frame 0 tiled to INGEST_T frames per camera with
# noise, planted rolls on four cameras and a brightening on two, through
# the estimator's chunk loop at the CLI's batch
INGEST_T, INGEST_BATCH = 16, 8
INGEST_DY, INGEST_DX = (6, 0, -8, 0, 0, 4, -3), (-5, 0, 3, 0, 0, 8, -7)
INGEST_GAIN = (1.0, 1.06, 1.0, 1.0, 1.06, 1.0, 1.0)
INGEST_REF = os.path.join("deepfly3d_torch", "data", "ingest_t16.npz")
# the JAX package's results for the core phase's new options
# (python tests/test_torch_options.py --write)
OPTIONS_REF = os.path.join("deepfly3d_torch", "data", "options_t15.npz")
HEATMAP_HW = (64, 128)
# the h36m phase: the profile's 4-stack 128-wide network (weights from the
# seed in H36M_REF, which holds the JAX package's results on the frames)
# over 8 frames of 4 cameras of 1000x1000 at the CLI's batch of 8
# (python tests/test_torch_h36m.py --write)
H36M_REF = os.path.join("deepfly3d_torch", "data", "h36m_t4.npz")
H36M_BATCH = 8
H36M_PER_BATCH = {"fused_bottleneck": 59, "upsample2x_add": 16, "decode_heatmaps": 1,
                  "preprocess_resize": 1}
H36M_CONF_TOL = 2e-5
H36M_TIES = 0.05        # at most this share of image-joints within 10x the conf tolerance of a tie
VIDEO_FRAMES = 4        # frames of the video phase (scripts/make_video_goldens.py)
# per-shape times that are summed per path and per kernel
TIMES = ("ms", "plain_ms", "library_ms", "eager_ms", "library_eager_ms", "bound_ms",
         "bound_f32_ms", "unfused_ms")
CELL_ATOL = 1e-6        # same argmax cell: cells are >= 1/128 apart
SOURCES = {
    "fused_bottleneck": ("deepfly3d_torch/ops/csrc/bottleneck.cu",
                         "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                         ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                          "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
    "upsample2x_add": ("deepfly3d_torch/ops/csrc/upsample_add.cu",
                       "deepfly3d_tpu/ops/pallas/kernels.py:49", []),
    "decode_heatmaps": ("deepfly3d_torch/ops/csrc/decode.cu",
                        "deepfly3d_tpu/ops/pallas/kernels.py:97", []),
    "preprocess_resize": ("deepfly3d_torch/ops/csrc/preprocess.cu",
                          "deepfly3d_tpu/ops/pallas/kernels.py:133", []),
}


def ingest_frames(frames0, drift=True):
    """Golden frame 0 (C, H, W, 3) uint8 -> (C * INGEST_T, H, W, 3) uint8,
    camera-major: each camera's frame plus uniform noise in [-3, 3]
    (``RandomState(0)``, whose stream numpy keeps fixed), then with ``drift``
    rolled by (INGEST_DY, INGEST_DX) and scaled by INGEST_GAIN (rounded)."""
    import numpy as np

    C = frames0.shape[0]
    noise = np.random.RandomState(0).randint(-3, 4, size=(C, INGEST_T) + frames0.shape[1:],
                                             dtype=np.int8)
    out = np.empty((C, INGEST_T) + frames0.shape[1:], np.uint8)
    for c in range(C):
        f = np.clip(frames0[c][None].astype(np.int16) + noise[c], 0, 255)
        if drift:
            f = np.roll(f, (INGEST_DY[c], INGEST_DX[c]), axis=(1, 2)).astype(np.float32)
            f = np.clip(np.rint(f * np.float32(INGEST_GAIN[c])), 0, 255)
        out[c] = f.astype(np.uint8)
    return out.reshape((C * INGEST_T,) + frames0.shape[1:])


def ingest_chunk(frames0, order, drift=True):
    """The ingest phase's one chunk: [(frames, cams, flip)], camera-major, the
    cameras at ordering positions 4-6 flipped."""
    import numpy as np

    cams = np.repeat(np.arange(frames0.shape[0]), INGEST_T)
    return [(ingest_frames(frames0, drift), cams, np.isin(cams, np.asarray(order)[4:]))]


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=10, replays=5):
    """Device time of one ``fn()``: ``iters`` calls captured into a CUDA graph
    and replayed, so that no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def times(torch, kernel, plain, library):
    """The time keys of one kernel row: device times of the kernel's wrapper and
    of the one library call, their eager times beside, and the plain version's
    eager time (it is no yardstick of speed, and the preprocess's copies its
    resize matrices from the host in every call, which no graph captures)."""
    return {"ms": graph_ms(torch, kernel), "library_ms": graph_ms(torch, library),
            "eager_ms": cuda_ms(torch, kernel), "library_eager_ms": cuda_ms(torch, library),
            "plain_ms": cuda_ms(torch, plain)}


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def record_shapes(twin, path, rows, run):
    """Run ``twin`` (a plain twin, which launches no kernel) once through
    ``run(twin)`` with every stage wrapped: count each (kernel, shape) the
    path gives its kernels."""
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.ops import kernels

    def note(kernel, key, extra=None):
        row = rows.setdefault((kernel, key), {"counts": collections.Counter(), "extra": extra})
        row["counts"][path] += 1

    def block(x, folded):
        note("fused_bottleneck", tuple(x.shape) + (folded["w1"].shape[1],
                                                   folded["w3"].shape[1], "wp" in folded),
             folded)
        return bn.bottleneck_plain(x, folded)

    def merge(inner, skip):
        note("upsample2x_add", tuple(inner.shape))
        return kernels.upsample2x_add_plain(inner, skip)

    def decode(hm):
        note("decode_heatmaps", tuple(hm.shape))
        return kernels.decode_heatmaps_plain(hm)

    def preprocess(x_u8, flip, out_shape, dtype, shift=None, gain=None):
        note("preprocess_resize", tuple(x_u8.shape) + tuple(out_shape))
        return image_ops.preprocess_frames_plain(x_u8, flip, out_shape, dtype, shift=shift,
                                                 gain=gain)

    for net in twin.nets().values():
        net.block_fn, net.merge_fn = block, merge
    twin.decode, twin.preprocess = decode, preprocess
    run(twin)


def host_probe():
    """What this machine can decode JPEG and video with: OpenCV, the prebuilt
    native ingest library, the libjpeg and libav headers that building it
    needs, and an ffmpeg binary."""
    import shutil

    from deepfly3d_torch.io import native

    probe = {}
    try:
        import cv2

        probe["cv2"] = cv2.__version__
    except ImportError as e:
        probe["cv2"] = f"no: {e}"
    probe["native_ingest"] = "loads" if native.available() else f"no: {native.load_error}"
    probe["headers"] = native.headers_found()
    probe["ffmpeg"] = shutil.which("ffmpeg")
    probe["jpeg_decoder"] = native.available() or not probe["cv2"].startswith("no")
    return probe


def ingest_phase(torch, np, est, frames0, order, counters, rows, card):
    """The estimator's chunk loop (``infer_chunks``, which ``infer_folder`` and
    ``infer_videos`` run) on golden frame 0 tiled to INGEST_T frames per
    camera and drifted, at INGEST_BATCH with the conv checkpoint.  Checks the
    registration against the planted drift, the launches (1 preprocess, 31
    bottleneck, 8 upsample-add and 1 decode per batch, the counts recorded
    from the plain twin), the output against the plain twin (points equal,
    conf within 1e-5) and against the JAX package's (INGEST_REF: cells,
    conf within 2e-5).  -> {kernel: launches}."""
    from deepfly3d_torch.pipeline import plain_twin

    chunk = ingest_chunk(frames0, order)
    frames, cams, _ = chunk[0]
    C = frames0.shape[0]
    clean = {}
    est._register_chunk(ingest_chunk(frames0, order, drift=False)[0][0], cams, clean)

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    reg = {}
    t0 = time.perf_counter()
    pts, conf = est.infer_chunks(chunk, INGEST_BATCH, registration=reg)
    t_first = time.perf_counter() - t0
    got = {c.__name__: c.launches for c in counters}
    batches = -(-len(frames) // INGEST_BATCH)
    want = {"fused_bottleneck": 31 * batches, "upsample2x_add": 8 * batches,
            "decode_heatmaps": batches, "preprocess_resize": batches}
    recorded = collections.Counter()
    for (kernel, _), row in rows.items():
        recorded[kernel] += row["counts"]["ingest"]
    if got != want or got != dict(recorded):
        raise AssertionError(f"ingest launches {got}, want {want} (recorded {dict(recorded)})")
    print(f"ingest launches for {batches} batches of {INGEST_BATCH}: {got} "
          f"(per batch 1 / 31 / 8 / 1)")
    found = [(reg[c][0] - clean[c][0], reg[c][1] - clean[c][1]) for c in range(C)]
    if found != list(zip(INGEST_DY, INGEST_DX)) or \
            [reg[c][2] != clean[c][2] for c in range(C)] != [g != 1.0 for g in INGEST_GAIN]:
        raise AssertionError(f"ingest registration {reg} (clean frames {clean}): planted rolls "
                             f"{list(zip(INGEST_DY, INGEST_DX))}, gains {INGEST_GAIN}")
    print(f"ingest registration (dy, dx, gain): {[reg[c] for c in range(C)]}; the planted "
          f"rolls found on every camera, the measured gain passed to the preprocess")

    twin = plain_twin(est)
    before = [c.launches for c in counters]
    q_pts, q_conf = twin.infer_chunks(chunk, INGEST_BATCH)
    if [c.launches for c in counters] != before:
        raise AssertionError("the plain estimator launched a kernel")
    conf_diff = float(np.abs(conf - q_conf).max())
    if not np.array_equal(pts, q_pts) or conf_diff > 1e-5:
        raise AssertionError(f"ingest vs plain twin: points equal {np.array_equal(pts, q_pts)}, "
                             f"conf {conf_diff}")
    with np.load(os.path.join(ROOT, INGEST_REF)) as z:
        ref = {k: z[k] for k in z.files}
    cell_diff = float(np.abs(pts - ref["pts"]).max())
    conf_vs_jax = float(np.abs(conf - ref["conf"]).max())
    reg_jax = [(int(a), int(b), float(g)) for a, b, g in zip(ref["dy"], ref["dx"], ref["gain"])]
    if cell_diff > CELL_ATOL or conf_vs_jax > 2e-5 or reg_jax != [reg[c] for c in range(C)]:
        raise AssertionError(f"ingest vs JAX: cells {cell_diff}, conf {conf_vs_jax}, "
                             f"registration {reg_jax}")
    print(f"ingest vs plain twin on the card: points equal, conf max diff {conf_diff}; vs JAX "
          f"({INGEST_REF}): same cells (max diff {cell_diff}), conf {conf_vs_jax} (<= 2e-5), "
          f"same registration")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    warm = [timed(lambda: est.infer_chunks(chunk, INGEST_BATCH, registration=reg))
            for _ in range(3)]
    plain = timed(lambda: twin.infer_chunks(chunk, INGEST_BATCH, registration=reg))
    estimate = timed(lambda: est._register_chunk(frames, cams, {}))
    print(f"informational: ingest of {INGEST_T} 7-camera frames from host memory, batch "
          f"{INGEST_BATCH}: first call {INGEST_T / t_first:.1f} frames/s (registration "
          f"estimated on the host: {estimate:.3f} s), then with the registration known "
          f"{[round(INGEST_T / t, 1) for t in warm]} frames/s (pinned staging, copy, device); "
          f"plain versions {INGEST_T / plain:.1f} frames/s; on {card}")
    return got


def count_launches(torch, counters, run):
    """Every launch count set to 0 just before ``run()`` and read just after:
    -> (run's result, {kernel: launches})."""
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}


def check_launches(name, got, batches):
    """1 preprocess, 31 bottleneck, 8 upsample-add and 1 decode launch per batch."""
    want = {"fused_bottleneck": 31 * batches, "upsample2x_add": 8 * batches,
            "decode_heatmaps": batches, "preprocess_resize": batches}
    if got != want:
        raise AssertionError(f"{name} launches {got}, want {want} ({batches} batches)")
    print(f"{name} launches for {batches} batches: {got}")


def conf38(np, conf, order):
    """(C, T, 19, 1) per-camera confidences -> (C, T, 38) on the assembled
    joints (0 where the assembly keeps none of the camera's predictions)."""
    C, T, K, _ = conf.shape
    out = np.zeros((C, T, 2 * K))
    for pos, cam in enumerate(order):
        if pos != 3:
            side = slice(0, K) if pos < 3 else slice(K, 2 * K)
            out[cam, :, side] = conf[cam, ..., 0]
    return out


def core_phase(np, torch, device, card, probe, counters, batch_size=8):
    """The recording entry point on the card, over a temporary copy of
    tests/data/reference (15 frames x 7 cameras, conv checkpoint):

    * ``cli.main`` (argmax, parity bundle adjustment), held to the golden
      contract; a Core seeded with golden 2D through the parity calibration
      chain, held to the golden 3D result;
    * (a) ``cli.main --soft-argmax --solver lm``: the argmax run's cells the
      JAX argmax's, conf within 2e-5 of JAX's, refined points within half a
      heatmap cell of the argmax run's and within 1e-4 of JAX's where conf >=
      0.1 (OPTIONS_REF, written by the JAX package);
    * (b) the lm chain seeded with golden 2D: plain and cut to 12 Huber
      iterations, calibration within 1e-4 and points3d within 1e-5 of JAX's;
      30 Huber iterations, the objective within 1e-6 relative;
    * (c) ``Core.solve_pictorial`` on frames 0-1 (golden 2D and calibration,
      the card's heatmaps): the JAX test's criteria and the corrected 2D leg
      points within 1e-3 of JAX's;
    * the StageTimer reports and the pose2d stage's parts.

    Raises where no JPEG decoder loads.  -> {path: {kernel: launches}} of the
    three network runs (cli, cli_options, pictorial)."""
    import contextlib
    import io
    import logging
    import shutil
    import tempfile

    from deepfly3d_torch import cli, logger
    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.core import Core
    from deepfly3d_torch.io import result_schema
    from deepfly3d_torch.models.inference import PoseEstimator, _read_images_threaded
    from deepfly3d_torch.utils.profiling import StageTimer

    if not probe["jpeg_decoder"]:
        raise SystemExit(f"chip_smoke: core phase cannot run: no JPEG decoder loads on this "
                         f"machine (cv2: {probe['cv2']}; native ingest: "
                         f"{probe['native_ingest']}; headers: {probe['headers']})")
    golden_dir = os.path.join(ROOT, "tests", "data", "reference_df3d")
    with open(os.path.join(golden_dir, "df3d_result_2d.pkl"), "rb") as fh:
        golden_2d = pickle.load(fh)
    with open(os.path.join(golden_dir, "df3d_result_3d.pkl"), "rb") as fh:
        golden_3d = pickle.load(fh)
    with np.load(os.path.join(ROOT, OPTIONS_REF)) as z:
        ref = {k: z[k] for k in z.files}
    order = list(range(7))
    batches = -(-7 * 15 // batch_size)
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_")
    records = []
    launches = {}

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    def stage_report():
        metrics = [m for m in records if m.startswith("stage metrics: ")]
        return json.loads(metrics[-1][len("stage metrics: "):])

    def run_cli(name, out, *flags):
        args = [rec, "--output-folder", out, "--batch-size", str(batch_size), "-v",
                "--device", str(device), *flags]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc, launches[name] = count_launches(torch, counters, lambda: cli.main(args))
        wall = time.perf_counter() - t0
        print(printed.getvalue(), end="")
        if rc != 0:
            raise AssertionError(f"cli.main {flags} returned {rc}")
        check_launches(f"core phase, cli.main {' '.join(flags) or '(defaults)'}:",
                       launches[name], batches)
        return result_schema.load_result(result_schema.result_path(out, rec)), wall, printed

    keep = Keep()
    logger.getLogger().addHandler(keep)
    try:
        rec = os.path.join(tmp, "reference")
        shutil.copytree(os.path.join(ROOT, "tests", "data", "reference"), rec)
        saved, wall, _ = run_cli("cli", os.path.join(tmp, "out"))
        pts_err = float(np.abs(saved["points2d"] - golden_2d["points2d"]).max())
        conf_err = float(np.abs(saved["heatmap_confidence"]
                                - golden_2d["heatmap_confidence"]).max())
        if not (pts_err <= 0.02 and conf_err <= 0.002):
            raise AssertionError(f"core phase: cli golden contract pts_err {pts_err}, "
                                 f"conf_err {conf_err}")
        print(f"core phase: cli.main on the bundled recording (15 frames x 7 cameras): "
              f"pts_err {pts_err} (<= 0.02), conf_err {conf_err} (band 0.002); "
              f"{wall:.2f} s wall")
        print(f"informational: core stage times (StageTimer) on {card}: "
              f"{json.dumps(stage_report())}")
        hard = saved["points2d"]

        seeded = Core(rec, os.path.join(tmp, "seeded"), 0, order, device=device)
        seeded.points2d, seeded.conf = golden_2d["points2d"], golden_2d["heatmap_confidence"]
        t0 = time.perf_counter()
        seeded.calibrate_calc(0, 100)
        t_ba = time.perf_counter() - t0
        seeded.save()
        with open(seeded.save_path, "rb") as fh:
            got = pickle.load(fh)
        err3d = max(float(np.abs(got[k] - golden_3d[k]).max())
                    for k in ("points3d_wo_procrustes", "points3d"))
        err_cal = max(float(np.abs(got[c][k] - golden_3d[c][k]).max())
                      for c in range(7) for k in got[c])
        if not (err3d <= 1e-5 and err_cal <= 1e-4):
            raise AssertionError(f"core phase: calibration chain points3d {err3d}, calib {err_cal}")
        print(f"core phase: seeded calibration chain: points3d_wo_procrustes / points3d "
              f"max err {err3d} (<= 1e-5), calibration {err_cal} (<= 1e-4); bundle "
              f"adjustment {t_ba:.2f} s on the host")

        # (a) the new options through the CLI
        soft, wall, printed = run_cli("cli_options", os.path.join(tmp, "options"),
                                      "--soft-argmax", "--solver", "lm")
        p38, conf = soft["points2d"], soft["heatmap_confidence"]
        cell_diff = float(np.abs(hard - ref["hard_p38"]).max())
        conf_vs_jax = float(np.abs(conf - ref["soft_conf"]).max())
        half_cell = float((np.abs(p38 - hard) * HEATMAP_HW).max())
        sure = conf38(np, conf, order) >= 0.1
        soft_vs_jax = float(np.abs(p38 - ref["soft_p38"])[sure].max())
        soft_vs_jax_all = float(np.abs(p38 - ref["soft_p38"]).max())
        if cell_diff > CELL_ATOL or conf_vs_jax > 2e-5 or half_cell > 0.5 + 1e-5 \
                or soft_vs_jax > 1e-4:
            raise AssertionError(f"(a) soft-argmax cli: argmax cells vs JAX {cell_diff}, conf "
                                 f"vs JAX {conf_vs_jax}, refined vs argmax {half_cell} cells, "
                                 f"refined vs JAX {soft_vs_jax} (conf >= 0.1)")
        reproj = [line for line in printed.getvalue().splitlines() if "Reprojection" in line]
        print(f"(a) cli.main --soft-argmax --solver lm: the argmax run's cells are JAX's (max "
              f"diff {cell_diff}); conf vs JAX {conf_vs_jax} (<= 2e-5); refined points within "
              f"{half_cell} heatmap cells of the argmax run's (<= 0.5); vs JAX {soft_vs_jax} "
              f"on {int(sure.sum())} joints with conf >= 0.1 (<= 1e-4), {soft_vs_jax_all} over "
              f"all joints; lm calibration: {reproj[-1]} (informational); {wall:.2f} s wall")
        print(f"informational: stage times of the new options (StageTimer, soft-argmax pose2d "
              f"and lm calibrate) on {card}: {json.dumps(stage_report())}")

        # (b) the seeded lm chain, from the same float64 input bits as JAX's
        for run, kw in (("lm", {}), ("hub12", {"huber_px": 5.0, "max_iters": 12}),
                        ("hub", {"huber_px": 5.0})):
            core = Core(rec, os.path.join(tmp, run), 0, order, device=device)
            core.points2d, core.conf = golden_2d["points2d"], golden_2d["heatmap_confidence"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                result = core.calibrate_calc(0, 100, solver="lm", **kw)
                t_ba = time.perf_counter() - t0
                core.save()
            with open(core.save_path, "rb") as fh:
                got = pickle.load(fh)
            err_cal = max(float(np.abs(np.stack([got[c][k] for c in order])
                                       - ref[f"{run}_{k}"]).max()) for k in ("R", "tvec"))
            err3d = max(float(np.abs(got[k] - ref[f"{run}_{k}"]).max())
                        for k in ("points3d_wo_procrustes", "points3d"))
            cost_rel = abs(result.cost_final - float(ref[f"{run}_cost"])) / float(ref[f"{run}_cost"])
            held = run != "hub"      # 30 Huber iterations follow the round-off (ROADMAP Queue 3)
            if cost_rel > 1e-6 or (held and (err_cal > 1e-4 or err3d > 1e-5)):
                raise AssertionError(f"(b) lm chain {run} {kw}: calibration {err_cal}, points3d "
                                     f"{err3d}, objective {cost_rel} relative")
            print(f"(b) seeded lm chain {kw or 'plain'} vs JAX: calibration {err_cal}"
                  f"{' (<= 1e-4)' if held else ' (informational)'}, points3d {err3d}"
                  f"{' (<= 1e-5)' if held else ' (informational)'}, final objective "
                  f"{cost_rel} relative (<= 1e-6); {result.iterations} iterations, "
                  f"{t_ba:.2f} s on the host")

        # (c) pictorial-structures correction on frames 0-1
        core = Core(rec, os.path.join(tmp, "pictorial"), 2, order, device=device)
        core.points2d = np.array(golden_2d["points2d"][:, :2])
        core.conf = np.array(golden_2d["heatmap_confidence"][:, :2])
        core.calib = result_schema.extract_calib(golden_3d)
        before = np.array(core.points2d)
        timer = StageTimer(device=device)
        with timer.stage("solve_pictorial"):
            out, launches["pictorial"] = count_launches(
                torch, counters, lambda: core.solve_pictorial(batch_size=batch_size))
        check_launches("core phase, solve_pictorial:", launches["pictorial"],
                       -(-7 * 2 // batch_size))
        shift = float(np.median(np.abs(core.points2d[0, :, :15] - before[0, :, :15])))
        pic_vs_jax = float(np.abs(core.points2d - ref["pic_p2"]).max())
        chains = {side: np.abs(out[side] - ref[f"pic_{side}"]).reshape(2, 3, 5, 3).max(axis=(2, 3))
                  for side in ("left", "right")}
        differ = sum(int((d > 1e-3).sum()) for d in chains.values())
        if not (all(out[s].shape == (2, 15, 3) and np.isfinite(out[s]).all() for s in out)
                and shift < 0.01 and pic_vs_jax <= 1e-3):
            raise AssertionError(f"(c) solve_pictorial: median shift {shift}, corrected 2D vs "
                                 f"JAX {pic_vs_jax}")
        print(f"(c) Core.solve_pictorial (frames 0-1, golden 2D and calibration, heatmaps from "
              f"the card): shapes (2, 15, 3), finite, median leg shift {shift} (< 0.01); "
              f"corrected 2D leg points vs JAX {pic_vs_jax} (<= 1e-3); {differ} of 12 chains "
              f"differ from JAX's by more than 1e-3 in 3D")
        print(f"informational: solve_pictorial stage time (StageTimer) on {card}: "
              f"{json.dumps(timer.metrics())}")

        # the pose2d stage's parts, one by one, as infer_folder runs them
        split = {}

        def part(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[name] = time.perf_counter() - t
            return out

        est = part("estimator_build", lambda: PoseEstimator(
            os.path.join(WEIGHTS_DIR, CONV), device=device))
        paths = [os.path.join(rec, f"camera_{c}_img_{t}.jpg") for c in range(7) for t in range(15)]
        images = part("jpeg_decode", lambda: _read_images_threaded(paths))
        cams = np.repeat(np.arange(7), 15)
        gain, dy, dx = part("registration_estimate", lambda: est._register_chunk(images, cams, {}))
        flip = np.isin(cams, [4, 5, 6])
        for name in ("inference_first", "inference"):
            part(name, lambda: est.infer_images(images, flip, batch_size, gain=gain,
                                                shift=(dy, dx)))
        decoder = ("native libjpeg" if probe["native_ingest"] == "loads"
                   else f"OpenCV {probe['cv2']}")
        print(f"informational: the pose2d stage's parts in seconds ({decoder} decode, 16 "
              f"threads; inference = pinned staging, copies and device for 105 images at batch "
              f"{batch_size}): {json.dumps(split)}; on {card}")
        return launches
    finally:
        logger.getLogger().removeHandler(keep)
        shutil.rmtree(tmp, ignore_errors=True)


def softargmax_phase(torch, np, dev, est, frames0, order, card):
    """(d) ``decode_softargmax`` on the ingest phase's heatmaps, in batches of
    INGEST_BATCH: on the card (cells from the decode kernel) against a CPU
    copy (the plain decode): the same cells and confidences, points within
    1e-5, both methods.  Device times per batch: the decode kernel, the
    refinement alone and the whole soft-argmax decode."""
    from deepfly3d_torch.models import decode as decode_mod
    from deepfly3d_torch.ops import kernels

    _, _, heatmaps = est.infer_chunks(ingest_chunk(frames0, order), INGEST_BATCH,
                                      return_heatmaps=True)
    hw = heatmaps.shape[1:3]
    worst = {}
    for method in ("parabolic", "window"):
        for lo in range(0, len(heatmaps), INGEST_BATCH):
            hm_cpu = torch.from_numpy(np.ascontiguousarray(heatmaps[lo:lo + INGEST_BATCH]))
            hm = hm_cpu.to(dev)
            cells = decode_mod.argmax_cells(kernels.decode_heatmaps(hm)[0], hw)
            cells_cpu = decode_mod.argmax_cells(kernels.decode_heatmaps_plain(hm_cpu)[0], hw)
            pts, conf = decode_mod.decode_softargmax(hm, method=method)
            q_pts, q_conf = decode_mod.decode_softargmax(hm_cpu, method=method)
            torch.cuda.synchronize()
            if not (all(torch.equal(a.cpu(), b) for a, b in zip(cells, cells_cpu))
                    and torch.equal(conf.cpu(), q_conf)):
                raise AssertionError(f"(d) soft-argmax {method}, batch at {lo}: cells or conf "
                                     f"differ between the card and the CPU")
            worst[method] = max(worst.get(method, 0.0), (pts.cpu() - q_pts).abs().max().item())
    if max(worst.values()) > 1e-5:
        raise AssertionError(f"(d) soft-argmax card vs CPU: points {worst} > 1e-5")
    hm = torch.from_numpy(np.ascontiguousarray(heatmaps[:INGEST_BATCH])).to(dev)
    r0, c0 = decode_mod.argmax_cells(kernels.decode_heatmaps(hm)[0], hw)
    timing = {"decode_kernel_ms": graph_ms(torch, lambda: kernels.decode_heatmaps(hm))}
    for method in ("parabolic", "window"):
        timing[f"refine_{method}_ms"] = graph_ms(
            torch, lambda: decode_mod.softargmax_refine(hm, r0, c0, method=method))
        timing[f"softargmax_{method}_ms"] = graph_ms(
            torch, lambda: decode_mod.decode_softargmax(hm, method=method))
    timing["refine_parabolic_eager_ms"] = cuda_ms(
        torch, lambda: decode_mod.softargmax_refine(hm, r0, c0))
    print(f"(d) soft-argmax on the ingest phase's {len(heatmaps)} heatmaps {tuple(hw)}, "
          f"batches of {INGEST_BATCH}: cells and conf equal card vs CPU, points max diff "
          f"{worst} (<= 1e-5)")
    print(f"informational: device ms per batch of {INGEST_BATCH} (replayed CUDA graphs; "
          f"eager: CUDA events around eager calls): {json.dumps(timing)}; on {card}")


def h36m_inputs(np, tmp):
    """The h36m phase's inputs, made from the seed in H36M_REF: -> (reference
    arrays, checkpoint path in ``tmp``, frames (C, T, 1000, 1000, 3) uint8,
    the calibration prior of their rig)."""
    from deepfly3d_torch.utils import synthetic

    with np.load(os.path.join(ROOT, H36M_REF)) as z:
        ref = {k: z[k] for k in z.files}
    stacks, features, depth, classes, h, w = (int(v) for v in ref["spec"])
    ckpt = os.path.join(tmp, "hourglass_h36m_seeded.npz")
    synthetic.random_checkpoint(ckpt, int(ref["seed"]), stacks, features, depth, classes, (h, w))
    rig = synthetic.human_rig()
    frames, _, _ = synthetic.human_frames(int(ref["seed"]), int(ref["frames"]), rig)
    return ref, ckpt, frames, rig


def h36m_chunk(np, frames):
    """(C, T, H, W, 3) -> the ingest loop's one chunk, camera-major, no flips."""
    C, T = frames.shape[:2]
    return [(frames.reshape((C * T,) + frames.shape[2:]), np.repeat(np.arange(C), T),
             np.zeros(C * T, bool))]


def hold_to_reference(np, name, pts, conf, ref):
    """Raise unless the cells are JAX's (within CELL_ATOL) wherever JAX's top-2
    margin exceeds 10x the conf tolerance, conf is within H36M_CONF_TOL and at
    most H36M_TIES of the image-joints are near-ties; print the counts."""
    conf_diff = float(np.abs(conf - ref["conf"]).max())
    sure = ref["margin"] > 10 * H36M_CONF_TOL
    cell_diff = float(np.abs(pts - ref["pts"])[sure].max())
    ties = int((~sure).sum())
    moved = int((np.abs(pts - ref["pts"]).max(-1) > CELL_ATOL)[~sure].sum())
    if conf_diff > H36M_CONF_TOL or cell_diff > CELL_ATOL or ties > H36M_TIES * sure.size:
        raise AssertionError(f"{name} vs JAX: conf {conf_diff}, cells {cell_diff} outside "
                             f"near-ties, {ties} near-ties of {sure.size}")
    print(f"{name} vs JAX ({H36M_REF}): conf max diff {conf_diff} (<= {H36M_CONF_TOL}); same "
          f"cells (max diff {cell_diff}) on {int(sure.sum())} of {sure.size} image-joints; "
          f"{ties} near-ties (top-2 margin <= {10 * H36M_CONF_TOL}, <= {H36M_TIES:.0%} allowed) "
          f"excluded, {moved} of them in another cell")


def h36m_phase(torch, np, dev, est, ref, frames, counters, rows, card):
    """(e) The estimator's chunk loop on the h36m frames at H36M_BATCH: the
    launches per batch (and as recorded from the plain twin), the output
    against the JAX package's and against the plain twin on the card,
    frames/s and device ms per batch.  -> {kernel: launches}."""
    from deepfly3d_torch.models.inference import infer_batch
    from deepfly3d_torch.pipeline import plain_twin

    chunk = h36m_chunk(np, frames)
    C, T = frames.shape[:2]
    batches = -(-C * T // H36M_BATCH)
    (pts, conf), got = count_launches(torch, counters,
                                      lambda: est.infer_chunks(chunk, H36M_BATCH))
    want = {k: v * batches for k, v in H36M_PER_BATCH.items()}
    recorded = collections.Counter()
    for (kernel, _), row in rows.items():
        recorded[kernel] += row["counts"]["h36m"]
    if got != want or got != dict(recorded):
        raise AssertionError(f"(e) h36m launches {got}, want {want} (recorded {dict(recorded)})")
    print(f"(e) h36m ingest launches for {batches} batches of {H36M_BATCH}: {got} (per batch "
          f"{' / '.join(str(H36M_PER_BATCH[k]) for k in ('preprocess_resize', 'fused_bottleneck', 'upsample2x_add', 'decode_heatmaps'))}"
          f" preprocess / bottleneck / upsample-add / decode)")
    if not (pts.shape == (C * T, 17, 2) and conf.shape == (C * T, 17, 1)
            and np.isfinite(conf).all()):
        raise AssertionError(f"(e) h36m outputs {pts.shape}, {conf.shape}")
    hold_to_reference(np, "(e) h36m ingest on the card", pts, conf, ref)
    twin = plain_twin(est)
    before = [c.launches for c in counters]
    q_pts, q_conf = twin.infer_chunks(chunk, H36M_BATCH)
    if [c.launches for c in counters] != before:
        raise AssertionError("the plain h36m estimator launched a kernel")
    hold_to_reference(np, "(e) h36m plain twin on the card", q_pts, q_conf, ref)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    warm = [timed(lambda: est.infer_chunks(chunk, H36M_BATCH)) for _ in range(3)]
    images = torch.from_numpy(chunk[0][0][:H36M_BATCH]).to(dev)
    flip = torch.zeros(H36M_BATCH, dtype=torch.bool, device=dev)
    batch_ms = graph_ms(torch, lambda: infer_batch(est.net, images, flip, est.input_shape),
                        iters=3, replays=3)
    print(f"informational: h36m ingest of {T} 4-camera frames of 1000x1000 from host memory, "
          f"batch {H36M_BATCH}: {[round(T / t, 1) for t in warm]} frames/s (pinned staging, "
          f"copy, device); device {batch_ms:.3f} ms per batch of {H36M_BATCH} (replayed CUDA "
          f"graph: preprocess, network, decode); on {card}")
    return got


def h36m_cli_phase(torch, np, device, ckpt, frames, rig, counters, tmp):
    """(f) ``cli.main --profile h36m --solver lm`` over the h36m frames written
    as JPEGs (the checkpoint in ``tmp``, where no rig template lies): a finite
    4-camera 17-joint result, the launches, and its 2D against the port's own
    ingest of the decoded JPEGs on the card.  -> {kernel: launches}."""
    import contextlib
    import io

    from deepfly3d_torch import cli
    from deepfly3d_torch.io import result_schema
    from deepfly3d_torch.models.inference import PoseEstimator, _read_images_threaded
    from deepfly3d_torch.utils.synthetic import write_jpegs

    C, T = frames.shape[:2]
    rec = os.path.join(tmp, "h36m_recording")
    paths = write_jpegs(rec, frames)
    prior = os.path.join(tmp, "h36m_prior.pkl")
    with open(prior, "wb") as fh:
        pickle.dump(rig, fh)
    out = os.path.join(tmp, "h36m_out")
    args = [rec, "--output-folder", out, "--profile", "h36m", "--calib-prior", prior,
            "--checkpoint", ckpt, "--solver", "lm", "--batch-size", str(H36M_BATCH), "-v",
            "--device", str(device)]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc, got = count_launches(torch, counters, lambda: cli.main(args))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"(f) cli.main --profile h36m returned {rc}")
    batches = -(-C * T // H36M_BATCH)
    want = {k: v * batches for k, v in H36M_PER_BATCH.items()}
    if got != want:
        raise AssertionError(f"(f) cli.main --profile h36m launches {got}, want {want}")
    saved = result_schema.load_result(result_schema.result_path(out, rec))
    shapes = (saved["points2d"].shape, saved["heatmap_confidence"].shape, saved["points3d"].shape)
    if shapes != ((C, T, 17, 2), (C, T, 17, 1), (T, 17, 3)) \
            or not np.isfinite(saved["points3d"]).all() \
            or list(saved["camera_ordering"]) != list(range(C)):
        raise AssertionError(f"(f) h36m result shapes {shapes}, ordering "
                             f"{saved['camera_ordering']}, finite "
                             f"{np.isfinite(saved['points3d']).all()}")
    est = PoseEstimator(ckpt, device=device)
    if est.rig is not None:
        raise AssertionError("(f) the h36m checkpoint found a rig template")
    images = _read_images_threaded(paths)
    pts, conf = est.infer_images(images, np.zeros(len(paths), bool), H36M_BATCH)
    pts_diff = float(np.abs(saved["points2d"] - pts.reshape(C, T, 17, 2)).max())
    conf_diff = float(np.abs(saved["heatmap_confidence"] - conf.reshape(C, T, 17, 1)).max())
    if pts_diff != 0.0 or conf_diff != 0.0:
        raise AssertionError(f"(f) h36m cli 2D vs the port's ingest of the same JPEGs: points "
                             f"{pts_diff}, conf {conf_diff}")
    reproj = [line for line in printed.getvalue().splitlines() if "Reprojection" in line]
    print(f"(f) cli.main --profile h36m --solver lm on {C} cameras x {T} frames of 1000x1000 "
          f"JPEGs: launches {got}; points2d {shapes[0]}, points3d {shapes[2]} finite; 2D equal to "
          f"the port's ingest of the decoded JPEGs (points {pts_diff}, conf {conf_diff}); "
          f"{reproj[-1] if reproj else ''} (informational); {wall:.2f} s wall")
    return got


def video_phase(np, device, card):
    """``cli.main --skip-pose-estimation --video-2d --video-3d`` over a copy of
    the bundled recording seeded with the golden result (first VIDEO_FRAMES
    frames): both mp4s open with VIDEO_FRAMES frames of the golden videos'
    size.  Fails where cv2.VideoWriter cannot write mp4v."""
    import contextlib
    import io
    import logging
    import shutil
    import tempfile

    import cv2

    from deepfly3d_torch import cli, logger
    from deepfly3d_torch.io import result_schema

    def read(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame.shape)
        cap.release()
        return frames

    tmp = tempfile.mkdtemp(prefix="df3d_smoke_video_")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    logger.getLogger().addHandler(keep)
    try:
        probe = os.path.join(tmp, "probe.mp4")
        writer = cv2.VideoWriter(probe, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 32))
        opened = writer.isOpened()
        writer.write(np.zeros((32, 64, 3), np.uint8))
        writer.release()
        print(f"video probe: cv2 {cv2.__version__} VideoWriter mp4v opens: {opened}, "
              f"{os.path.getsize(probe) if os.path.exists(probe) else 0} bytes for one frame")
        if not opened:
            raise SystemExit("chip_smoke: video phase cannot run: cv2.VideoWriter does not open "
                             "with mp4v on this machine")
        rec = os.path.join(tmp, "reference")
        shutil.copytree(os.path.join(ROOT, "tests", "data", "reference"), rec)
        with open(os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_3d.pkl"),
                  "rb") as fh:
            golden = pickle.load(fh)
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        result_schema.save_result(
            result_schema.result_path(out, rec), points2d=golden["points2d"],
            camera_ordering=golden["camera_ordering"],
            heatmap_confidence=golden["heatmap_confidence"],
            calib=result_schema.extract_calib(golden), points3d=golden["points3d"],
            points3d_wo_procrustes=golden["points3d_wo_procrustes"])
        args = [rec, "--output-folder", out, "--skip-pose-estimation", "--video-2d",
                "--video-3d", "-n", str(VIDEO_FRAMES), "--output-fps", "5", "-v",
                "--device", str(device)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"video phase: cli.main returned {rc}")
        sizes = {}
        for kind in ("2d", "3d"):
            name = f"video_pose{kind}_" + rec.replace("/", "_") + ".mp4"
            got = read(os.path.join(out, name))
            want = read(os.path.join(ROOT, "tests", "data", "golden_videos",
                                     f"video_pose{kind}.mp4"))
            if len(got) != VIDEO_FRAMES or set(got) != {want[0]}:
                raise AssertionError(f"video phase: {name} has {len(got)} frames of "
                                     f"{sorted(set(got))}, want {VIDEO_FRAMES} of {want[0]}")
            sizes[kind] = want[0]
        metrics = [m for m in records if m.startswith("stage metrics: ")]
        stages = json.loads(metrics[-1][len("stage metrics: "):])
        print(f"video phase: cli.main --skip-pose-estimation --video-2d --video-3d on the bundled "
              f"recording's first {VIDEO_FRAMES} frames: both mp4s open with {VIDEO_FRAMES} "
              f"frames, 2D {sizes['2d']}, 3D {sizes['3d']} (the golden videos' size); "
              f"{wall:.2f} s wall")
        print(f"informational: video stage times (StageTimer) on {card}: {json.dumps(stages)}")
    finally:
        logger.getLogger().removeHandler(keep)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "deepfly3d_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from deepfly3d_torch.config import WEIGHTS_DIR, fly_config
    from deepfly3d_torch.models.cascade import build_cascade_pipeline
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.models.inference import PoseEstimator
    from deepfly3d_torch.ops import _build, canonicalize, geometry, image as image_ops
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin
    from deepfly3d_torch.utils.devices import full_f32

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    full_f32()
    card = gpu_name_and_limit()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    probe = host_probe()
    print(f"host probe: {json.dumps(probe)}")

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. the three paths, and the shapes they give each kernel
    cfg = fly_config()
    num_cameras = cfg.num_cameras
    N = BATCH_T * num_cameras
    ckpt = {name: load_weights(os.path.join(WEIGHTS_DIR, name)) for name in SHIPPED}
    with np.load(os.path.join(ROOT, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        ref0 = {k: z[k] for k in z.files}
    order = ref0["camera_ordering"]
    with open(cfg.calib_prior_path, "rb") as fh:
        calib = geometry.calib_to_arrays(pickle.load(fh), num_cameras, dtype=np.float32)
    rng = np.random.default_rng(0)
    noise = rng.integers(-3, 4, size=(BATCH_T,) + ref0["frames"].shape, dtype=np.int16)
    frames_np = np.clip(ref0["frames"][None].astype(np.int16) + noise, 0, 255).astype(np.uint8)
    frames = torch.from_numpy(frames_np).to(dev)

    def pipeline(name, rig="auto"):
        variables, spec = ckpt[name]
        return build_pipeline(spec, variables, calib, order, rig=rig, device=dev)

    def cascade(rig="auto"):
        return build_cascade_pipeline(*ckpt[STUDENT], *ckpt[CONV], calib, order,
                                      rig=rig, device=dev)

    paths = {"conv": pipeline(CONV), "p16": pipeline(P16), "cascade": cascade()}
    rows = {}
    for path, pipe in paths.items():
        record_shapes(plain_twin(pipe), path, rows, lambda twin: twin(frames))
    # the CLI's path: the estimator's chunk loop at batch 8 (ingest phase)
    estimator = PoseEstimator(os.path.join(WEIGHTS_DIR, CONV), device=dev)
    record_shapes(plain_twin(estimator), "ingest", rows, lambda twin: twin.infer_chunks(
        ingest_chunk(ref0["frames"], order), INGEST_BATCH))
    # the h36m profile's ingest path (h36m phase): its checkpoint in a folder
    # without a rig template
    h36m_tmp = tempfile.mkdtemp(prefix="df3d_smoke_h36m_")
    h36m_ref, h36m_ckpt, h36m_frames, h36m_rig = h36m_inputs(np, h36m_tmp)
    h36m_est = PoseEstimator(h36m_ckpt, device=dev)
    record_shapes(plain_twin(h36m_est), "h36m", rows, lambda twin: twin.infer_chunks(
        h36m_chunk(np, h36m_frames), H36M_BATCH))
    torch.cuda.synchronize()

    # ---- 4. kernel phase
    gen = torch.Generator().manual_seed(0)
    shape_rows = []
    per_kernel = {}
    per_path = {}

    def record(kernel, row, counts):
        total = sum(counts.values())
        shape_rows.append({"kernel": kernel, **row, "launches_by_path": dict(counts)})
        for path, count in counts.items():
            pp = per_path.setdefault(path, {}).setdefault(kernel, collections.Counter())
            pp["launches"] += count
            for key in TIMES:
                if key in row:
                    pp[key] += count * row[key]
        agg = per_kernel.setdefault(kernel, collections.Counter())
        for key in ("max_abs_err", "model_err"):
            if key in row:
                agg[key] = max(agg[key], row[key])
        for key in TIMES + ("flops", "bytes"):
            if key in row:
                agg[key] += total * row[key]

    def oihw(w2d):
        return w2d.t().contiguous()[:, :, None, None]

    def check_bottleneck(key, counts, f):
        n, h, w, cin, cmid, cout, proj = key
        x = torch.randn((n, h, w, cin), generator=gen).to(dev)
        y = bn.fused_bottleneck(x, f)
        ref = bn.bottleneck_plain(x, f)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        model_err = (y - bn.bottleneck_tf32_model(x, f)).abs().max().item()
        if not max(err, model_err) <= BLOCK_TOL * scale:
            raise AssertionError(f"bottleneck {key}: max abs err {err} (against its arithmetic "
                                 f"model {model_err}) > {BLOCK_TOL} x {scale}")
        lw = {"w1": oihw(f["w1"]), "w3": oihw(f["w3"]),
              "w2": f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1).contiguous()}
        if proj:
            lw["wp"] = oihw(f["wp"])

        def library():
            xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW view
            a1 = torch.relu(xc * f["s1"].view(1, -1, 1, 1) + f["t1"].view(1, -1, 1, 1))
            a2 = torch.relu(F.conv2d(a1, lw["w1"], f["b1"][0]))
            a3 = torch.relu(F.conv2d(a2, lw["w2"], f["b2"][0], padding=1))
            z = F.conv2d(a3, lw["w3"], f["b3"][0])
            return z + (F.conv2d(a1, lw["wp"], f["bp"][0]) if proj else xc)

        lib_err = (library().permute(0, 2, 3, 1) - ref).abs().max().item()
        flops = 2.0 * n * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                                   + (cin * cout if proj else 0))
        nbytes = 4.0 * (n * h * w * (cin + cout)
                        + sum(t.numel() for name, t in f.items() if name != "packed"))
        b_ms, b_by = bound_ms(3.0 * flops, nbytes, PEAK_TF32_FLOPS)   # 3 MMAs per product
        record("fused_bottleneck", {
            "shape": list(key[:6]), "proj": proj, "tile": list(bn.choose_tile(*key)),
            "max_abs_err": err, "model_err": model_err, "magnitude": scale,
            "library_err": lib_err, "bound_f32_ms": bound_ms(flops, nbytes)[0],
            **times(torch, lambda: bn.fused_bottleneck(x, f),
                    lambda: bn.bottleneck_plain(x, f), library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}, counts)

    def check_merge(key, counts):
        n, h, w, c = key
        inner = torch.randn(key, generator=gen).to(dev)
        skip = torch.randn((n, 2 * h, 2 * w, c), generator=gen).to(dev)
        out = kernels.upsample2x_add(inner, skip)
        ref = kernels.upsample2x_add_plain(inner, skip)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"upsample2x_add {key}: max abs err {err} != 0")
        nbytes = 4.0 * (inner.numel() + 2 * skip.numel())
        b_ms, b_by = bound_ms(float(skip.numel()), nbytes)

        def library():
            return skip + inner.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        record("upsample2x_add", {
            "shape": list(key), "max_abs_err": err,
            **times(torch, lambda: kernels.upsample2x_add(inner, skip),
                    lambda: kernels.upsample2x_add_plain(inner, skip), library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": float(skip.numel()),
            "bytes": nbytes}, counts)

    def check_decode(key, counts):
        n, h, w, k = key
        hm = torch.randn(key, generator=gen)
        hm[0, :, :, 0] = 1.0                              # planted ties
        hm[1 % n, 3, 4, 2] = hm[1 % n, h - 5, w - 7, 2] = 7.0
        hm[2 % n, :, :, 3] = -0.0                         # -0.0 ties with +0.0: first index
        hm[2 % n, h - 2, 1, 3] = 0.0
        hm[2 % n, h // 2, w // 3, 4] = float("nan")       # a NaN beats every number
        hm = hm.to(dev)
        pts, conf = kernels.decode_heatmaps(hm)
        ref_pts, ref_conf = kernels.decode_heatmaps_plain(hm)
        torch.cuda.synchronize()
        if not (conf[2 % n, 4].isnan().all() and ref_conf[2 % n, 4].isnan().all()
                and pts[2 % n, 3].tolist() == [0.0, 0.0]):
            raise AssertionError(f"decode {key}: the planted NaN or the signed zeros were missed")
        conf, ref_conf = conf.nan_to_num(nan=0.0), ref_conf.nan_to_num(nan=0.0)
        err = max((pts - ref_pts).abs().max().item(), (conf - ref_conf).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"decode {key}: max abs err {err} != 0")
        nbytes = 4.0 * (hm.numel() + pts.numel() + conf.numel())
        b_ms, b_by = bound_ms(float(hm.numel()), nbytes)
        hm_flat = hm.view(n, h * w, k)
        record("decode_heatmaps", {
            "shape": list(key), "max_abs_err": err,
            **times(torch, lambda: kernels.decode_heatmaps(hm),
                    lambda: kernels.decode_heatmaps_plain(hm),
                    lambda: torch.max(hm_flat, dim=1)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": float(hm.numel()),
            "bytes": nbytes}, counts)

    def check_preprocess(key, counts):
        n, h_in, w_in, c, h, w = key
        x = torch.randint(0, 256, (n, h_in, w_in, c), generator=gen, dtype=torch.uint8).to(dev)
        flip = (torch.arange(n) % 3 == 1).to(dev)
        dy, dx = (torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
                  for _ in range(2))
        gain = 0.9 + 0.2 * torch.rand(n, generator=gen)
        gain[::4] = 1.0
        gain = gain.to(dev)
        reg = {"shift": (dy, dx), "gain": gain}
        identity = (h, w) == (h_in, w_in)

        def kernel():                                       # as the paths call it
            return kernels.preprocess_resize(x, flip, (h, w), **reg)

        def unfused():                 # the registration as separate steps around it
            rolled = image_ops.roll_frames(x, (dy, dx))
            return kernels.preprocess_resize(rolled, flip, (h, w)) * gain[:, None, None, None]

        def plain(**registration):
            if identity:
                return kernels.preprocess_u8_plain(x, flip, **registration)
            return image_ops.preprocess_frames_plain(x, flip, (h, w), **registration)

        out, ref = kernel(), plain(**reg)
        bare, bare_ref = kernels.preprocess_resize(x, flip, (h, w)), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, unfused()):
            raise AssertionError(f"preprocess {key}: the fused shift and gain differ from the "
                                 f"kernel on rolled frames times the gain")
        err = max((out - ref).abs().max().item(), (bare - bare_ref).abs().max().item())
        tol = 0.0 if identity else PREPROCESS_TOL * max(1.0, gain.max().item())
        if not err <= tol:
            raise AssertionError(f"preprocess {key}: max abs err {err} > {tol}")

        def library():                                      # the same triangle filter
            xc = (image_ops.roll_frames(x, (dy, dx)).float() * (1.0 / 255.0)).permute(0, 3, 1, 2)
            y = F.interpolate(xc, size=(h, w), mode="bilinear", antialias=True,
                              align_corners=False).permute(0, 2, 3, 1)
            return torch.where(flip.reshape(n, 1, 1, 1), y.flip(2), y) * gain[:, None, None, None]

        lib_err = (library() - ref).abs().max().item()
        kh = image_ops.resize_taps(h_in, h, 1.0 / 255.0)[1].shape[1]
        kw = image_ops.resize_taps(w_in, w, 1.0)[1].shape[1]
        flops = 2.0 * n * c * (h * w_in * kh + h * w * kw) + n * h * w * c
        nbytes = float(x.numel() + 4 * out.numel() + 13 * n + 8 * (h * kh + w * kw)
                       + 4 * (h + w))
        b_ms, b_by = bound_ms(flops, nbytes)
        row = {"shape": list(key), "mode": "identity" if identity else "resize",
               "taps": [kh, kw], "plan": list(kernels.preprocess_plan(
                   h_in, w_in, c, h, w, kernels.PREPROCESS_STAGE_ROWS)),
               "max_abs_err": err, "tolerance": tol, "library_err": lib_err,
               **times(torch, kernel, lambda: plain(**reg), library),
               "unfused_ms": graph_ms(torch, unfused),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
        record("preprocess_resize", row, counts)

    checks = {"fused_bottleneck": check_bottleneck, "upsample2x_add": check_merge,
              "decode_heatmaps": check_decode, "preprocess_resize": check_preprocess}
    for (kernel, key), row in sorted(rows.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        if kernel == "fused_bottleneck":
            check_bottleneck(key, row["counts"], row["extra"])
        else:
            checks[kernel](key, row["counts"])
        torch.cuda.empty_cache()
    # identity mode: exactly the TPU kernel (u8 * 1/255, flip); on no path
    check_preprocess((N,) + tuple(cfg.image_hw) + (3,) + tuple(cfg.image_hw), {})
    # K x cells no multiple of 4: the decode kernel's scalar loads; on no path
    check_decode((N, 63, 127, 19), {})
    print(json.dumps({"kernel_shapes": shape_rows}))
    print(json.dumps({"per_path": per_path}))
    h36m_batches = -(-h36m_frames.shape[0] * h36m_frames.shape[1] // H36M_BATCH)
    print(f"informational: the h36m path per batch of {H36M_BATCH} images (kernel-phase times "
          f"of its shapes times their launches, over {h36m_batches} batches), on {card}: "
          + json.dumps({kernel: {key: row[key] / h36m_batches for key in
                                 ("launches", "ms", "bound_ms", "plain_ms", "library_ms")}
                        for kernel, row in per_path["h36m"].items()}))

    # ---- 5. slice phase, full width
    counters = (bn.fused_bottleneck, kernels.upsample2x_add, kernels.decode_heatmaps,
                kernels.preprocess_resize)
    launches = {}
    fps_lines = []

    def fps(p, iters=5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            p(frames)
        torch.cuda.synchronize()
        return BATCH_T * iters / (time.perf_counter() - t)

    for path, pipe in paths.items():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        pts3d, p38, conf = pipe(frames)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        recorded = collections.Counter()
        for (kernel, _), row in rows.items():
            recorded[kernel] += row["counts"][path]
        if got != EXPECTED[path] or got != dict(recorded):
            raise AssertionError(f"{path} path launches {got}, want {EXPECTED[path]} "
                                 f"(recorded {dict(recorded)})")
        launches[path] = got
        print(f"slice {path} launches: {got}")
        if not (torch.isfinite(pts3d).all() and pts3d.shape == (BATCH_T, 38, 3)
                and p38.shape == (num_cameras, BATCH_T, 38, 2)
                and conf.shape == (num_cameras, BATCH_T, 19, 1)):
            raise AssertionError(f"{path} outputs have the wrong shape or are not finite")
        plain = plain_twin(pipe)
        before = [c.launches for c in counters]
        q3d, q38, qconf = plain(frames)
        torch.cuda.synchronize()
        if [c.launches for c in counters] != before:
            raise AssertionError(f"the plain {path} pipeline launched a kernel")
        if path == "cascade" and not torch.equal(pipe.last_repaired, plain.last_repaired):
            raise AssertionError("the cascade repaired other images than its plain twin")
        if not torch.equal(p38, q38):
            n_diff = int((p38 != q38).any(-1).sum().item())
            raise AssertionError(f"{path} p38 differs from the plain pipeline at {n_diff} points")
        conf_diff = (conf - qconf).abs().max().item()
        pts3d_diff = ((pts3d - q3d).abs().max() / q3d.abs().max().clamp_min(1e-30)).item()
        if conf_diff > 1e-4 or pts3d_diff > 1e-5:
            raise AssertionError(f"{path} vs plain: conf {conf_diff}, points3d rel {pts3d_diff}")
        print(f"slice {path} vs plain on the card: p38 equal, conf max diff {conf_diff}, "
              f"points3d max rel diff {pts3d_diff}")
        pipe(frames), plain(frames)                        # warm both
        turns = [(fps(pipe), fps(plain)) for _ in range(2)]   # kernel, plain, kernel, plain
        fps_lines.append(
            f"informational: {path} frames/s in turns (7-camera frames, T={BATCH_T}, frames "
            f"already on the card): kernels {[k for k, _ in turns]}, plain versions "
            f"{[q for _, q in turns]}, on {card}")
        print(fps_lines[-1])

    # one conv call on drifted frames: planted rolls and gain, registration on
    drifted_np = np.stack([np.roll(frames_np[:, c], (DRIFT_DY[c], DRIFT_DX[c]), axis=(1, 2))
                           for c in range(num_cameras)], axis=1)
    drifted_np = np.clip(np.rint(drifted_np * np.float32(DRIFT_GAIN)), 0, 255).astype(np.uint8)
    drifted = torch.from_numpy(drifted_np).to(dev)
    conv = paths["conv"]
    clean_reg = canonicalize.estimate_tc(frames, conv.rig)
    dy, dx, gain = canonicalize.estimate_tc(drifted, conv.rig)
    if not (torch.equal((dy - clean_reg[0]).cpu(), torch.tensor(DRIFT_DY, dtype=torch.int32))
            and torch.equal((dx - clean_reg[1]).cpu(), torch.tensor(DRIFT_DX, dtype=torch.int32))
            and bool((gain != 1.0).all())):
        raise AssertionError(f"drifted frames: registration found dy {dy.tolist()}, dx "
                             f"{dx.tolist()}, gain {gain.tolist()} (clean {clean_reg}); planted "
                             f"rolls {DRIFT_DY}, {DRIFT_DX} and gain {DRIFT_GAIN}")
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    pts3d, p38, conf = conv(drifted)
    torch.cuda.synchronize()
    got = {c.__name__: c.launches for c in counters}
    if got != EXPECTED["conv"]:
        raise AssertionError(f"drifted conv call launches {got}, want {EXPECTED['conv']}")
    q3d, q38, qconf = plain_twin(conv)(drifted)
    torch.cuda.synchronize()
    conf_diff = (conf - qconf).abs().max().item()
    pts3d_diff = ((pts3d - q3d).abs().max() / q3d.abs().max().clamp_min(1e-30)).item()
    if not torch.equal(p38, q38) or conf_diff > 1e-4 or pts3d_diff > 1e-5:
        raise AssertionError(f"drifted conv vs plain: p38 equal {torch.equal(p38, q38)}, conf "
                             f"{conf_diff}, points3d rel {pts3d_diff}")
    print(f"slice conv on drifted frames: registration dy {dy.tolist()}, dx {dx.tolist()}, gain "
          f"{[round(g, 4) for g in gain.tolist()]} (clean frames: dy {clean_reg[0].tolist()}, "
          f"dx {clean_reg[1].tolist()}); launches {got}; vs plain: p38 equal, conf max diff "
          f"{conf_diff}, points3d max rel diff {pts3d_diff}")

    # ---- 5b. ingest phase: the CLI's chunk loop at batch 8
    launches["ingest"] = ingest_phase(torch, np, estimator, ref0["frames"], order, counters,
                                      rows, card)
    softargmax_phase(torch, np, dev, estimator, ref0["frames"], order, card)

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with open(argv[argv.index("--profile") + 1], "w") as fh:
            fh.write(card + "\n")
            chunk, ingest_reg = ingest_chunk(ref0["frames"], order), {}
            estimator.infer_chunks(chunk, INGEST_BATCH, registration=ingest_reg)
            calls = {path: (lambda pipe=pipe: pipe(frames)) for path, pipe in paths.items()}
            calls["ingest"] = lambda: estimator.infer_chunks(chunk, INGEST_BATCH,
                                                             registration=ingest_reg)
            calls["h36m"] = lambda: h36m_est.infer_chunks(h36m_chunk(np, h36m_frames),
                                                          H36M_BATCH)
            for path, call in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                events = prof.key_averages()
                kernels_run = [e for e in events if e.device_type == DeviceType.CUDA]
                total_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
                index_ms = sum(e.self_device_time_total for e in kernels_run
                               if "index" in e.key) / 1e3
                line = (f"profile {path}: device time {total_ms:.3f} ms per call, of it "
                        f"{index_ms:.3f} ms in index kernels; {wall_ms:.3f} ms on the host "
                        f"clock under the profiler")
                print(line)
                what = {"ingest": f"{INGEST_T} frames per camera in batches of {INGEST_BATCH}, "
                                  f"the registration known",
                        "h36m": f"{h36m_frames.shape[1]} frames of 4 cameras in batches of "
                                f"{H36M_BATCH}"}.get(path, f"T={BATCH_T}")
                fh.write(f"\n==== {path} path, one call at {what}; {line}\n")
                fh.write(events.table(sort_by="cuda_time_total", row_limit=40))

    # ---- 6. golden phase: frame 0, rig off
    with open(os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"),
              "rb") as fh:
        golden = pickle.load(fh)
    with np.load(os.path.join(ROOT, "deepfly3d_torch", "data",
                              "golden_t0_checkpoints.npz")) as z:
        ref_ck = {k: z[k] for k in z.files}
    runs = [(name[:-len(".npz")], pipeline(name, rig=None)) for name in SHIPPED]
    runs.append(("cascade", cascade(rig=None)))
    for key, pipe in runs:
        _, g38, gconf = pipe(ref0["frames"][None])
        g38, gconf = g38.cpu().numpy(), gconf.cpu().numpy()
        cell_diff = float(np.abs(g38 - ref_ck[f"{key}/p38"]).max())
        conf_vs_jax = float(np.abs(gconf - ref_ck[f"{key}/conf"]).max())
        pts_err = float(np.abs(g38 - golden["points2d"][:, :1]).max())
        conf_err = float(np.abs(gconf - golden["heatmap_confidence"][:, :1]).max())
        if cell_diff > CELL_ATOL or conf_vs_jax > 2e-5:
            raise AssertionError(f"golden frame, {key}: p38 vs JAX {cell_diff}, "
                                 f"conf vs JAX {conf_vs_jax}")
        print(f"golden frame 0, {key}: same cells as JAX (max diff {cell_diff}), conf vs JAX "
              f"{conf_vs_jax} (<= 2e-5); pts_err {pts_err}, conf_err {conf_err}")
        if key == CONV[:-len(".npz")]:
            if not (np.array_equal(g38, ref0["p38"]) and pts_err <= 0.02 and conf_err <= 0.002
                    and float(np.abs(gconf - ref0["conf"]).max()) <= 2e-5):
                raise AssertionError(f"golden frame, {key}: pts_err {pts_err}, conf_err "
                                     f"{conf_err}, or not the JAX folded path's output")
            print(f"golden contract, {key}: pts_err {pts_err} (<= 0.02), conf_err {conf_err} "
                  f"(band 0.002)")

    # ---- 7. core phase: the recording entry point with every option
    launches.update(core_phase(np, torch, dev, card, probe, counters))

    # ---- 8. h36m phase: (e) the ingest loop, (f) the CLI with --profile h36m
    try:
        launches["h36m"] = h36m_phase(torch, np, dev, h36m_est, h36m_ref, h36m_frames,
                                      counters, rows, card)
        launches["h36m_cli"] = h36m_cli_phase(torch, np, dev, h36m_ckpt, h36m_frames, h36m_rig,
                                              counters, h36m_tmp)
    finally:
        shutil.rmtree(h36m_tmp, ignore_errors=True)

    # ---- 9. video phase
    video_phase(np, dev, card)

    entries = []
    for name, (src, replaces, also) in SOURCES.items():
        agg = per_kernel[name]
        if name == "fused_bottleneck":
            _, b_by = bound_ms(3.0 * agg["flops"], agg["bytes"], PEAK_TF32_FLOPS)
        else:
            _, b_by = bound_ms(agg["flops"], agg["bytes"])
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "also_replaces": also, "launches": sum(launches[p][name] for p in launches),
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"], "bound_by": b_by,
            "library_ms": agg["library_ms"],
            "eager_ms": agg["eager_ms"], "library_eager_ms": agg["library_eager_ms"],
            "timing": "ms, library_ms: replayed CUDA graphs (device time); eager_ms, "
                      "library_eager_ms, plain_ms: CUDA events around eager calls",
            **({"bound_f32_ms": agg["bound_f32_ms"], "model_err": agg["model_err"],
                "arithmetic": "3 TF32 MMAs per product, f32 accumulate"}
               if name == "fused_bottleneck" else {}),
            "per": f"times: one call of each recorded path ({', '.join(EXPECTED)}, ingest, "
                   f"h36m) "
                   f"at T={BATCH_T}, the kernel-phase time of every shape times its launches; "
                   f"launches: every counted run ({', '.join(launches)})",
        }
        entries.append(entry)
    print(f"informational: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
