#!/usr/bin/env python3
"""Drive the PyTorch port's inference paths, its CLI, its fleet path, its trainer (float32 and bf16), the converted 256-wide checkpoint, the benchmark harness, the score-head calibration and the correction GUI on one CUDA card.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --profile FILE   # also a torch.profiler table per path and of
                                           # one training step

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. the card's name and power limit, torch and CUDA versions, and the host
   probe: whether OpenCV imports, whether the native ingest library loads,
   and whether the libjpeg and libav headers are there;
2. build the six CUDA sources of ``deepfly3d_torch/ops/csrc``;
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
   (weights from a seed, ``utils/synthetic``; the bottleneck's 128-wide
   instances, ``csrc/bottleneck_128.cu``, counted as
   ``fused_bottleneck_128``) over 8 seeded frames of 4 cameras of 1000x1000:
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
   frame count and size; the video2d and video3d stage seconds;
10. fleet phase (``parallel/``): (g) ``fleet.process_recordings`` over two
   copies of ``tests/data/reference`` (15 frames x 7 cameras each) and an
   empty folder, conv checkpoint, ``solver="lm"``, no mesh: the empty
   folder fails alone, the copies agree (2D equal, 3D within 1e-8), each
   holds the golden contract; (h) the same on a mesh of every visible card
   and on two entries of this card: one forward per entry (31 bottleneck
   launches each, as recorded from the plain twin), 2D within 1e-6 and conf
   within 1e-5 of (g); (i) ``make_batched_calibration`` of 8 perturbed golden
   problems in float64 on the card: each member has its unbatched
   ``_lm_solve``'s iterations and cameras within 1e-10 of the largest
   parameter, and JAX's result (``deepfly3d_torch/data/parallel_lm_b8.npz``)
   within 1e-4 / 1e-5; (j) ``make_sharded_triangulate`` over two entries:
   the golden ``points3d_wo_procrustes`` within 1e-5.  Frames/s split into
   decode, inference and calibrate (each stage reached once, calibrate once
   per good recording), the peak memory of the one-entry call, one entry's
   forward memory at 105 / 210 / 420 images and the shard size that would
   fill the card, the batched solve against 8 unbatched ones (each timed
   alone after a warm-up) and the fleet call's kernel column
   (informational).  A mesh over several
   cards runs the same code; one card cannot show that it overlaps them;
11. training phase (``models/train.py``, ``train_fly_weights``,
   ``parallel.make_sharded_train_step``): (k) golden frame 0 of the 7
   cameras through the trainable network's eval forward (cuDNN, TF32 off)
   against the folded forward through the kernels: heatmaps within 5e-5 of
   their magnitude, conf within 2e-5, the same cells; (o) the conv
   checkpoint read as one converted from torch (``proj_from_raw``) at T=8
   through the bottleneck kernel's raw-projection instances, with every
   launch count set to 0 just before (31 / 8 / 1 / 1), against its plain
   twin (its shapes join the kernel phase, with the raw instances at the
   h36m width and the 64-wide one); (l) 5 frozen-statistics Adam steps of
   the conv checkpoint on golden frame 0 of 4 cameras against the JAX
   package's trajectory (``deepfly3d_torch/data/train_fly_k5.npz``, the CPU
   test's tolerances); (m) ``train_fly_weights.main`` with ``--resume --steps
   200 --batch-size 24`` from a copy of the conv checkpoint in a temporary
   folder, every count set to 0 just before (its two evals run the serving
   path: 62 / 16 / 2 / 3 launches), steps/s, images/s, peak memory and the
   golden errors (informational); (n) ``make_sharded_train_step`` at full
   width, batch 8, on one entry and on two entries of this card, against
   each other and the one-device step (losses rtol 1e-5, parameters 1e-5);
12. bf16 phase (``compute_dtype="bfloat16"``, the JAX package's bf16
   deployment): four paths at full width, T=8, rig on: ``conv_bf16``
   (``hourglass_fly_tpu.npz``), ``p16_bf16`` (``hourglass_fly_p16_tpu.npz``),
   ``cascade_bf16`` (both nets at bf16) and ``p16_bf16_preprocess`` (also
   ``preprocess_dtype="bfloat16"``).  (p) their plain twins record every
   shape; (q) the kernel phase at bf16 at those shapes and at the h36m
   network's 128-wide blocks (seeded, batch 8): the bottleneck within 2 bf16
   ulps of its plain version's largest magnitude, upsample-add bit-equal,
   the bf16-output preprocess within one ulp of each element, the share that
   differs printed; ``bound_ms`` at 989 TFLOP/s and 2-byte activations,
   ``library_ms`` cuDNN / PyTorch in native bf16; (r) each path with every
   count set to 0 just before and read just after: the bf16 instances only
   (and the float32 decode, and the float32 preprocess where the spec's
   ``preprocess_dtype`` is), each net against its plain twin on the same
   input (heatmaps within 6% of their magnitude, conf within 5e-3 or twice
   the twin's gap to the float32 net, the same cells wherever the twin's
   top-2 margin exceeds 1e-2, twice the 5e-3 peak bound), frames/s and device ms per
   call beside the float32 path of the same checkpoints (informational); (s) golden frame 0
   (rig off) through every bf16 configuration and the bf16 cascade against
   the JAX package's bf16 results (``deepfly3d_torch/data/bf16_t0.npz``,
   ``bf16_cells_check``), with the golden errors printed beside the JAX
   package's on the CPU (informational);
13. wide phase (the converter's default output, a 256-wide checkpoint, which
   runs the bottleneck kernel's general instance ``bottleneck_general.cu``):
   a seeded torch state dict under the sh8 names at a trained net's scale,
   converted by ``convert_torch.main`` at its defaults.  (u) the kernel phase
   of the general instance at every shape the two paths below give it (the
   raw projecting stem block at 56x128x256, the 256->128->256 blocks at
   56x64x128 ... 56x4x8) and at the README toy trainer's widths and a width
   no multiple of 8 (TOY_SHAPES), float32 within 5e-5 of the output's
   magnitude, bf16 within 2 bf16 ulps; ``bound_ms`` at three TF32 MMAs per
   product (float32) and 989 TFLOP/s (bf16), ``library_ms`` cuDNN
   ``F.conv2d`` (TF32 off; native bf16); (t) ``build_pipeline`` at T=8, rig
   on, with every count set to 0 just before and read just after (31
   general-instance launches, 8 upsample-add, 1 decode, 1 preprocess, none
   of the six-width instances), each net against its plain twin on the same
   input (conf within 2e-5, the same cells above a 2e-4 top-2 margin, at most
   5% of the image-joints within it), frames/s and device ms per call
   (informational); ``PoseEstimator.infer_images`` on golden frame 0 and
   ``cli.main --checkpoint`` over the bundled recording's first frames, each
   counted; (v) the same spec at ``compute_dtype="bfloat16"`` under phase
   12's rule (``bf16_twin_check``); (w) ``train_fly_weights`` at the README's
   toy size in a temporary folder: its evals run the general instance;
14. bf16 training phase (log lines ``(w) bf16``): (l)'s 5 frozen-statistics
   steps at ``compute_dtype="bfloat16"`` against the JAX package's bf16
   trajectory (``deepfly3d_torch/data/train_fly_bf16_k5.npz``: each step's
   losses within ``BF16_K5_FRAC`` of JAX's bf16-vs-float32 gap, parameters
   within 2 lr per step); one BN-training Adam step at batch 24, float32 and
   bf16, device time and peak memory (informational); ``train_fly_weights
   --resume --dtype bfloat16 --steps 100 --batch-size 24`` in a temporary
   folder, every count set to 0 just before (its evals run the unfolded bf16
   network between the preprocess and decode kernels: 3 preprocess and 2
   decode launches, no block), steps/s and peak memory beside phase 11's
   (m); the data-parallel bf16 step on 1 and 2 entries of this card against
   the one-device step (losses within ``BF16_DP_FRAC`` of its
   bf16-vs-float32 gap);
15. harness phase (``deepfly3d_torch/bench.py``, log lines ``(x)``):
   ``verify_contract`` on the conv pipeline over the 15 golden frames (it
   must pass; counted: 31 / 8 / 1 / 1), ``load_probe_frames`` with all six
   probes, each probe's frames' digest and its ``verify_contract`` errors
   against the JAX package's committed report
   (``deepfly3d_torch/data/bench_probes_conv.json``: points within 1e-6, conf
   within 2e-5), each counted; ``measure_fps`` and ``pipeline_mfu`` of conv,
   p16 and cascade at T=8 (counted) and ``bench_bundle_adjust``
   (informational);
16. calibration phase (``deepfly3d_torch/calibrate_score_head.py``, log line
   ``(y)``): the conv checkpoint at bf16 with its 1x1 head embedded as 3x3:
   ``extract_features`` of the 105 golden images (1 preprocess launch, the
   unfolded bf16 network), ``compute_gram``, one ``make_device_check`` (held
   to the forward's own heatmaps), ``fit_scores`` cut to ``CAL_JOINTS``, and
   the deployed ``verify_contract`` through ``build_pipeline`` (the bf16
   instances: 31 / 8 / 1 / 1), with the time of each part (informational);
17. GUI phase (``deepfly3d_torch/gui.py``, log lines ``(z)``): whether PyQt5
   imports here, then the real ``DeepflyGUI`` under the headless Qt stand-in
   of ``tests/torch_qt_standin.py``, set up with ``device="cuda"`` on a copy
   of the bundled recording, frames 0-1, seeded as (c): Pose, Correction, a
   drag on camera 1's view, Save (the pickle resumes in ``Core``), then the
   Auto-correct click, counted (the same launches as (c)) and held to (c)'s
   ``Core.solve_pictorial`` points2d within 1e-6, with its seconds.

Then one JSON line with every kernel's numbers and, last, the device line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import types

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
H36M_PER_BATCH = {"fused_bottleneck": 0, "fused_bottleneck_128": 59, "upsample2x_add": 16,
                  "decode_heatmaps": 1, "preprocess_resize": 1}
H36M_CONF_TOL = 2e-5
H36M_TIES = 0.05        # at most this share of image-joints within 10x the conf tolerance of a tie
VIDEO_FRAMES = 4        # frames of the video phase (scripts/make_video_goldens.py)
# the fleet phase: two copies of the bundled recording (15 frames x 7 cameras)
# and an empty folder through parallel.fleet.process_recordings; one forward
# per mesh entry; the batched lm solve of 8 perturbed golden problems against
# the JAX package's (python tests/test_torch_parallel.py --write)
FLEET_COPIES, FLEET_T = 2, 15
PER_FORWARD = {"fused_bottleneck": 31, "upsample2x_add": 8, "decode_heatmaps": 1,
               "preprocess_resize": 1}
LM_BATCH_REF = os.path.join("deepfly3d_torch", "data", "parallel_lm_b8.npz")
SAME_SOLVE_RTOL = 1e-10  # batched vs unbatched lm: of the largest camera parameter
FLEET_QUICK_N = 100      # kernel-phase shapes of >= this many images are timed with fewer repeats
# per-shape times that are summed per path and per kernel
TIMES = ("ms", "plain_ms", "library_ms", "eager_ms", "library_eager_ms", "bound_ms",
         "bound_f32_ms", "unfused_ms")
CELL_ATOL = 1e-6        # same argmax cell: cells are >= 1/128 apart
# the training phase: (l) the frozen-statistics fine-tune (the recipe's last
# phase, lr 1e-4) of the conv checkpoint for 5 full-batch steps on golden
# frame 0 of 4 cameras (4 and 5 flipped) against the JAX package's trajectory
# (python tests/test_torch_train.py --write); (m) the training script
K5_REF = os.path.join("deepfly3d_torch", "data", "train_fly_k5.npz")
K5_CAMERAS = (0, 1, 4, 5)
K5_LR = 1e-4
K5_LEAVES = ("params/stem_conv/kernel", "params/stem_bn/scale", "params/stem_res1/proj/kernel",
             "params/hg1/up_d4_0/conv2/kernel", "params/feat_bn1/bias", "params/score1/kernel",
             "params/score1/bias", "batch_stats/stem_bn/var", "batch_stats/hg0/skip_d4_0/bn1/var",
             "batch_stats/feat_bn1/var")
TRAIN_HM_TOL = 5e-5     # trainable (cuDNN f32) vs folded (kernels) heatmaps, of their magnitude
SHARDED_BATCH = 8       # (n) the data-parallel step at full width, 2 steps
TRAIN_BATCH = 24        # the script's batch: (m) and --profile's training step
SCRIPT_ARGS = ["--resume", "--steps", "200", "--batch-size", str(TRAIN_BATCH)]
# the bfloat16 serving path (phase 12): the JAX package's bf16 results on golden
# frame 0 (python tests/test_torch_bf16.py --write), its configurations (spec
# fields besides compute_dtype="bfloat16"), and the forward bound, the JAX
# package's own bf16 spread: heatmaps within 6% of their largest magnitude;
# confidences within 5e-3, or within twice the largest difference between a
# bf16 and the float32 forward on the same input where that is larger (two
# bf16 forwards each lie that far from the float32 one); the same argmax cell
# wherever the reference's top-2 heatmap margin exceeds 2e-3 (the largest
# margin at which the port's plain bf16 forward leaves JAX's cell on the CPU
# is 1.76e-3; JAX's own bf16 and float32 forwards part at up to 1.0e-3), and
# no more differing cells in all than 2 + twice the number at which the bf16
# and float32 forwards differ
BF16_REF = os.path.join("deepfly3d_torch", "data", "bf16_t0.npz")
BF16_CONFIGS = {"hourglass_fly": {}, "hourglass_fly_tpu": {}, "hourglass_fly_p16": {},
                "hourglass_fly_p16_tpu": {}, "hourglass_fly_fast_nearparity": {},
                "hourglass_fly_p16_tpu+bf16_preprocess": {"preprocess_dtype": "bfloat16"}}
BF16_HEATMAP_TOL = 0.06
BF16_CONF_TOL = 5e-3
BF16_MARGIN = 2e-3


def bf16_conf_tol(spread):
    """The confidence bound of two bf16 forwards whose bf16 and float32
    forwards differ by at most ``spread``."""
    return max(BF16_CONF_TOL, 2.0 * float(spread))
SOURCES = {
    "fused_bottleneck": ("deepfly3d_torch/ops/csrc/bottleneck.cu",
                         "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                         ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                          "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
    # the float32 128-wide instances of the h36m path (phase 8)
    "fused_bottleneck_128": ("deepfly3d_torch/ops/csrc/bottleneck_128.cu",
                             "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                             ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                              "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
    "upsample2x_add": ("deepfly3d_torch/ops/csrc/upsample_add.cu",
                       "deepfly3d_tpu/ops/pallas/kernels.py:49", []),
    "decode_heatmaps": ("deepfly3d_torch/ops/csrc/decode.cu",
                        "deepfly3d_tpu/ops/pallas/kernels.py:97", []),
    "preprocess_resize": ("deepfly3d_torch/ops/csrc/preprocess.cu",
                          "deepfly3d_tpu/ops/pallas/kernels.py:133", []),
    # the bfloat16 instances of the bf16 paths (phase 12)
    "fused_bottleneck_bf16": ("deepfly3d_torch/ops/csrc/bottleneck_bf16.cu",
                              "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                              ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                               "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
    "upsample2x_add_bf16": ("deepfly3d_torch/ops/csrc/upsample_add.cu",
                            "deepfly3d_tpu/ops/pallas/kernels.py:49", []),
    "preprocess_resize_bf16": ("deepfly3d_torch/ops/csrc/preprocess.cu",
                               "deepfly3d_tpu/ops/pallas/kernels.py:133", []),
    # the general-width instances of the converted 256-wide paths (phase 13)
    "fused_bottleneck_general": ("deepfly3d_torch/ops/csrc/bottleneck_general.cu",
                                 "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                                 ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                                  "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
    "fused_bottleneck_general_bf16": ("deepfly3d_torch/ops/csrc/bottleneck_general.cu",
                                      "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                                      ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                                       "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
}


def decode_np(np, hm):
    """(N, H, W, K) heatmaps -> (cells (N, K) first-index argmax, conf (N, K),
    top-2 margin (N, K)), in numpy."""
    n, h, w, k = hm.shape
    flat = hm.reshape(n, h * w, k)
    top2 = np.sort(flat, axis=1)[:, -2:]
    return flat.argmax(axis=1).astype(np.int32), top2[:, 1], top2[:, 1] - top2[:, 0]


def assemble38_np(np, pts19, order):
    """(C, T, 19, 2) -> (C, T, 38, 2), ``pipeline.assemble38`` in numpy."""
    C, T, K, _ = pts19.shape
    order = np.asarray(order)
    left, right = order[:3], order[4:]
    p38 = np.zeros((C, T, 2 * K, 2), np.float32)
    p38[left, :, :K] = pts19[left]
    p38[right, :, K:] = pts19[right]
    p38[int(order[2]), :, 15:] = 0.0
    p38[int(order[4]), :, K + 15:] = 0.0
    p38[right, ..., 1] = 1.0 - p38[right, ..., 1]
    return p38


def cells_p38(np, cells, order, hw):
    """Per-image cells (C, K) of (H, W) heatmaps -> the assembled (C, 1, 38, 2)."""
    pts = np.stack([(cells // hw[1]).astype(np.float32) / np.float32(hw[0]),
                    (cells % hw[1]).astype(np.float32) / np.float32(hw[1])], axis=-1)
    return assemble38_np(np, pts[:, None], order)


def bf16_cells_check(np, what, p38, want, margin, jax_spread, order):
    """The argmax-cell part of the bf16 forward bound, on golden frame 0 (or
    any (C, 1, 38, 2) pair): ``p38`` must equal ``want`` wherever the
    reference's margin (C, 19) exceeds BF16_MARGIN, and differ at no more than
    2 + 2 * ``jax_spread`` entries in all.  -> (differing entries, allowed,
    share of image-joints at or below the margin); raises otherwise."""
    order = np.asarray(order)
    decided = np.zeros(p38.shape[:3], bool)
    decided[order[:3], :, :19] = (margin[order[:3]] > BF16_MARGIN)[:, None]
    decided[order[4:], :, 19:] = (margin[order[4:]] > BF16_MARGIN)[:, None]
    differ = (np.abs(p38 - want) > CELL_ATOL).any(-1)
    allowed = 2 + 2 * int(jax_spread)
    if differ[decided].any() or differ.sum() > allowed:
        raise AssertionError(f"{what}: {int(differ[decided].sum())} cells differ where the "
                             f"margin exceeds {BF16_MARGIN}, {int(differ.sum())} in all "
                             f"(allowed {allowed})")
    return int(differ.sum()), allowed, float((margin <= BF16_MARGIN).mean())


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


def times(torch, kernel, plain, library, quick=False):
    """The time keys of one kernel row: device times of the kernel's wrapper and
    of the one library call, their eager times beside, and the plain version's
    eager time (it is no yardstick of speed, and the preprocess's copies its
    resize matrices from the host in every call, which no graph captures).
    ``quick``: fewer repeats, for the fleet's whole-shard shapes."""
    g, e = (dict(iters=3, replays=2), dict(iters=3, warmup=1)) if quick else ({}, {})
    return {"ms": graph_ms(torch, kernel, **g), "library_ms": graph_ms(torch, library, **g),
            "eager_ms": cuda_ms(torch, kernel, **e),
            "library_eager_ms": cuda_ms(torch, library, **e),
            "plain_ms": cuda_ms(torch, plain, **e)}


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

    def note(kernel, key, extra=None, dtype="float32"):
        kernel += "_bf16" if str(dtype).endswith("bfloat16") else ""   # the bf16 instances
        row = rows.setdefault((kernel, key), {"counts": collections.Counter(), "extra": extra})
        row["counts"][path] += 1

    def block(x, folded):
        key = tuple(x.shape) + (folded["w1"].shape[1], folded["w3"].shape[1], "wp" in folded,
                                "proj_raw" in folded)
        if bn.kernel_for(*key[3:7]) == "general":
            kernel = "fused_bottleneck_general"
        elif bn.streams_w2(*key[3:7], str(x.dtype).replace("torch.", "")):
            kernel = "fused_bottleneck_128"
        else:
            kernel = "fused_bottleneck"
        note(kernel, key, folded, x.dtype)
        return bn.bottleneck_plain(x, folded)

    def merge(inner, skip):
        note("upsample2x_add", tuple(inner.shape), dtype=skip.dtype)
        return kernels.upsample2x_add_plain(inner, skip)

    def decode(hm):
        note("decode_heatmaps", tuple(hm.shape))
        return kernels.decode_heatmaps_plain(hm)

    def preprocess(x_u8, flip, out_shape, dtype, shift=None, gain=None):
        note("preprocess_resize", tuple(x_u8.shape) + tuple(out_shape), dtype=dtype)
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
    recorded = recorded_launches(rows, "ingest")
    if got != want or nonzero(got) != recorded:
        raise AssertionError(f"ingest launches {got}, want {want} (recorded {recorded})")
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


def recorded_launches(rows, path):
    """{kernel: launches} that ``record_shapes`` counted on ``path``, the
    kernels it gave no shape there left out."""
    out = collections.Counter()
    for (kernel, _), row in rows.items():
        out[kernel] += row["counts"][path]
    return {k: v for k, v in out.items() if v}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def count_launches(torch, counters, run):
    """Every launch count set to 0 just before ``run()`` and read just after:
    -> (run's result, {kernel: launches}): each wrapper's ``launches``, and its
    other counters (``COUNTERS``) where they counted a launch."""
    zero_counts(counters)
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    got = {c.__name__: c.launches for c in counters}
    got.update({k: v for k, v in counts_with_bf16(counters).items() if v and k not in got})
    return out, got


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

    Raises where no JPEG decoder loads.  -> ({path: {kernel: launches}} of the
    three network runs (cli, cli_options, pictorial), (c)'s corrected points2d)."""
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
        pictorial_p2 = np.array(core.points2d)

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
        return launches, pictorial_p2
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
    recorded = recorded_launches(rows, "h36m")
    if got != want or nonzero(got) != recorded:
        raise AssertionError(f"(e) h36m launches {got}, want {want} (recorded {recorded})")
    print(f"(e) h36m ingest launches for {batches} batches of {H36M_BATCH}: {got} (per batch "
          f"{' / '.join(str(H36M_PER_BATCH[k]) for k in ('preprocess_resize', 'fused_bottleneck_128', 'upsample2x_add', 'decode_heatmaps'))}"
          f" preprocess / bottleneck / upsample-add / decode)")
    if not (pts.shape == (C * T, 17, 2) and conf.shape == (C * T, 17, 1)
            and np.isfinite(conf).all()):
        raise AssertionError(f"(e) h36m outputs {pts.shape}, {conf.shape}")
    hold_to_reference(np, "(e) h36m ingest on the card", pts, conf, ref)
    twin = plain_twin(est)
    before = counts_with_bf16(counters)
    q_pts, q_conf = twin.infer_chunks(chunk, H36M_BATCH)
    if counts_with_bf16(counters) != before:
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


def fleet_inputs(np):
    """The fleet's images as ``process_recordings`` decodes them: (the bundled
    recording's 15 x 7 JPEG paths, camera-major) -> ((FLEET_COPIES * 105,
    480, 960, 3) uint8, flips), one recording's images after the other."""
    from deepfly3d_torch.models.inference import _read_images_threaded

    paths = [os.path.join(ROOT, "tests", "data", "reference", f"camera_{c}_img_{t}.jpg")
             for c in range(7) for t in range(FLEET_T)]
    images = _read_images_threaded(paths)
    flips = np.repeat(np.arange(7) >= 4, FLEET_T)
    return np.concatenate([images] * FLEET_COPIES), np.concatenate([flips] * FLEET_COPIES)


@contextlib.contextmanager
def fleet_stage_timer(torch):
    """Host-clock spans (the card synchronised at both ends) of the fleet's
    stages, by wrapping what ``process_recordings`` calls: JPEG decode,
    inference (the estimator's batched loop or the sharded forward) and each
    recording's calibration.  Yields {stage: [seconds]}."""
    from deepfly3d_torch.core import Core
    from deepfly3d_torch.models import inference
    from deepfly3d_torch.parallel import pipeline

    spans = collections.defaultdict(list)

    def timed(stage, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[stage].append(time.perf_counter() - t0)
            return out
        return run

    make_infer = pipeline.make_sharded_infer
    patched = [(inference, "_read_images_threaded", timed("decode", inference._read_images_threaded)),
               (inference.PoseEstimator, "infer_images",
                timed("inference", inference.PoseEstimator.infer_images)),
               (pipeline, "make_sharded_infer",
                lambda *a, **k: timed("inference", make_infer(*a, **k))),
               (Core, "calibrate_calc", timed("calibrate", Core.calibrate_calc))]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]
    try:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
        yield spans
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def fleet_memory(torch, np, dev):
    """The card memory one mesh entry's forward needs, which grows with the
    images of its shard (a fleet call runs one forward per entry): the peak
    of ``make_sharded_infer`` on a one-entry mesh over 105, 210 and 420 of
    the fleet's images above what was allocated before it, and the shard
    size at which the card would be full, extrapolated from the last two.
    -> the informational text."""
    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.parallel import mesh, pipeline

    images, flips = fleet_inputs(np)
    images, flips = np.concatenate([images, images]), np.concatenate([flips, flips])
    variables, spec = load_weights(os.path.join(WEIGHTS_DIR, CONV))
    infer = pipeline.make_sharded_infer(spec, mesh.data_mesh(devices=[dev]), (256, 512))
    infer(variables, images[:8], flips[:8])           # the replica folded and kept
    peaks = {}
    for n in (105, 210, 420):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        infer(variables, images[:n], flips[:n])
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated(dev) - base
    per_image = (peaks[420] - peaks[210]) / 210
    total = torch.cuda.get_device_properties(dev).total_memory
    ceiling = 420 + (total - base - peaks[420]) / per_image
    return (f"one entry's forward needs "
            f"{', '.join(f'{peaks[n] / 2**30:.3f} GiB at {n}' for n in peaks)} images "
            f"({per_image / 2**20:.2f} MiB per image): the card's "
            f"{total / 2**30:.1f} GiB hold a shard of about {int(ceiling)} images")


def fleet_phase(torch, np, dev, card, counters, rows):
    """(g)-(j): ``parallel.fleet.process_recordings`` over two copies of the
    bundled recording and an empty folder, without a mesh and on meshes of one
    and two entries, the batched lm solve, and the sharded triangulation.
    -> {path: {kernel: launches}}."""
    import io

    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.ops import bundle_adjust, geometry
    from deepfly3d_torch.parallel import fleet, mesh, pipeline

    golden_dir = os.path.join(ROOT, "tests", "data", "reference_df3d")
    with open(os.path.join(golden_dir, "df3d_result_2d.pkl"), "rb") as fh:
        golden_2d = pickle.load(fh)
    with open(os.path.join(golden_dir, "df3d_result_3d.pkl"), "rb") as fh:
        golden_3d = pickle.load(fh)
    frames = FLEET_COPIES * FLEET_T
    images = FLEET_COPIES * 7 * FLEET_T
    launches, lines = {}, []
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_fleet_")
    try:
        folders = []
        for name in ("flyA", "flyB")[:FLEET_COPIES]:
            folders.append(os.path.join(tmp, name, "images"))
            shutil.copytree(os.path.join(ROOT, "tests", "data", "reference"), folders[-1])
        empty = os.path.join(tmp, "empty")
        os.makedirs(empty)

        def run(name, fleet_mesh):
            with fleet_stage_timer(torch) as spans, contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                results, got = count_launches(torch, counters, lambda: fleet.process_recordings(
                    folders + [empty], checkpoint=os.path.join(WEIGHTS_DIR, CONV),
                    mesh=fleet_mesh, solver="lm", num_images_max=FLEET_T,
                    camera_ordering=range(7), device=dev))
                wall = time.perf_counter() - t0
            if not (all(r.ok for r in results[:-1]) and not results[-1].ok
                    and results[-1].error is not None):
                raise AssertionError(f"{name}: ok {[r.ok for r in results]}, errors "
                                     f"{[str(r.error) for r in results]}")
            # one shared decode, one inference pass, one calibration per good recording:
            # a stage the timer no longer reaches would print 0 s
            calls = {stage: len(spans[stage]) for stage in ("decode", "inference", "calibrate")}
            if calls != {"decode": 1, "inference": 1, "calibrate": len(folders)}:
                raise AssertionError(f"{name}: stage spans {calls}, want one decode, one "
                                     f"inference and {len(folders)} calibrations")
            lines.append(f"{name} {frames / wall:.1f} frames/s ({wall:.3f} s: decode "
                         f"{sum(spans['decode']):.3f}, inference {sum(spans['inference']):.3f}, "
                         f"calibrate {[round(t, 3) for t in spans['calibrate']]} s)")
            return results, got

        # (g) no mesh: the estimator's batched loop at 8
        g_res, got = run("(g) no mesh", None)
        batches = -(-images // 8)
        want = {k: v * batches for k, v in PER_FORWARD.items()}
        if got != want:
            raise AssertionError(f"(g) launches {got}, want {want}")
        launches["fleet_g"] = got
        a, b = g_res[:2]
        d3 = float(np.abs(a.points3d - b.points3d).max())
        if not np.array_equal(a.points2d, b.points2d) or d3 > 1e-8:
            raise AssertionError(f"(g) copies differ: 2D equal {np.array_equal(a.points2d, b.points2d)}, "
                                 f"3D {d3}")
        errs = [(float(np.abs(r.points2d - golden_2d["points2d"][:, :FLEET_T]).max()),
                 float(np.abs(r.conf - golden_2d["heatmap_confidence"][:, :FLEET_T]).max()))
                for r in g_res[:2]]
        if any(p > 0.02 or c > 0.002 for p, c in errs):
            raise AssertionError(f"(g) golden contract (pts_err, conf_err) per copy: {errs}")
        print(f"(g) process_recordings, no mesh, over {FLEET_COPIES} copies of the bundled "
              f"recording ({FLEET_T} frames x 7 cameras) and an empty folder: the empty folder "
              f"failed alone ({type(g_res[-1].error).__name__}); the copies' 2D equal, 3D within "
              f"{d3} (<= 1e-8); golden contract (pts_err, conf_err) {errs}; launches {got} "
              f"({batches} batches of 8)")

        # (h) meshes of every visible card (one entry here) and of two entries on this card
        for key, fleet_mesh in (("fleet", mesh.data_mesh()),
                                ("fleet2", mesh.data_mesh(devices=[dev, dev]))):
            torch.cuda.reset_peak_memory_stats(dev)
            h_res, got = run(f"(h) {fleet_mesh.size}-entry mesh", fleet_mesh)
            peak = torch.cuda.max_memory_allocated(dev)
            want = {k: v * fleet_mesh.size for k, v in PER_FORWARD.items()}
            recorded = recorded_launches(rows, key)
            if got != want or nonzero(got) != recorded:
                raise AssertionError(f"(h) {fleet_mesh.size}-entry mesh launches {got}, want "
                                     f"{want} (recorded {recorded})")
            launches[key] = got
            d2 = max(float(np.abs(h.points2d - g.points2d).max()) for h, g in zip(h_res, g_res[:2]))
            dc = max(float(np.abs(h.conf - g.conf).max()) for h, g in zip(h_res, g_res[:2]))
            if d2 > 1e-6 or dc > 1e-5:
                raise AssertionError(f"(h) {fleet_mesh.size}-entry mesh vs (g): points {d2}, conf {dc}")
            print(f"(h) process_recordings on a {fleet_mesh.size}-entry mesh "
                  f"({[str(d) for d in fleet_mesh.devices.flat]}): one forward per entry, "
                  f"launches {got}; vs (g) points {d2} (<= 1e-6), conf {dc} (<= 1e-5)")
            if key == "fleet":
                lines.append(f"max_memory_allocated during the {fleet_mesh.size}-entry call "
                             f"(one forward of {images // fleet_mesh.size} images per entry) "
                             f"{peak / 2**30:.2f} GiB")

        lines.append(fleet_memory(torch, np, dev))

        # (i) the batched lm solve of 8 perturbed golden problems, float64 on the card
        with np.load(os.path.join(ROOT, LM_BATCH_REF)) as z:
            ref = {k: z[k] for k in z.files}
        B = ref["cams0"].shape[0]
        args = [torch.from_numpy(np.ascontiguousarray(np.broadcast_to(ref[k], (B,) + ref[k].shape)
                                                      if k not in ("cams0", "pts0") else ref[k]))
                .to(dev) for k in ("cams0", "pts0", "K", "dist", "obs", "mask")]
        iters_max = int(ref["max_iters"])
        calibrate = pipeline.make_batched_calibration((960, 480), max_iters=iters_max, device=dev)
        cams, pts, cost0, cost, iters = (t.cpu().numpy() for t in calibrate(*args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calibrate(*args)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        with torch.no_grad():
            bundle_adjust._lm_solve(*(a[0] for a in args), max_iters=iters_max)   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ones = [bundle_adjust._lm_solve(*(a[m] for a in args), max_iters=iters_max)
                    for m in range(B)]
            torch.cuda.synchronize()
            t_unbatched = time.perf_counter() - t0
        worst = 0.0
        for m, one in enumerate(ones):
            scale = one[0].abs().max().item()
            diff = float(np.abs(cams[m] - one[0].cpu().numpy()).max())
            worst = max(worst, diff / scale)
            if int(iters[m]) != one[4] or diff > SAME_SOLVE_RTOL * scale:
                raise AssertionError(f"(i) member {m}: {int(iters[m])} iterations against its "
                                     f"unbatched {one[4]}, cameras {diff} apart")
        c_diff = float(np.abs(cams - ref["cams"]).max())
        p_diff = float(np.abs(pts - ref["pts"]).max())
        if not (np.array_equal(iters, ref["iters"]) and c_diff <= 1e-4 and p_diff <= 1e-5):
            raise AssertionError(f"(i) vs JAX: iterations {iters.tolist()} / "
                                 f"{ref['iters'].tolist()}, cameras {c_diff}, points {p_diff}")
        print(f"(i) make_batched_calibration of {B} perturbed golden problems on the card "
              f"(float64): iterations {iters.tolist()}, each member's those of its unbatched "
              f"_lm_solve on the card, cameras within {worst:.3g} of the largest parameter "
              f"(<= {SAME_SOLVE_RTOL}); vs JAX ({LM_BATCH_REF}): same iterations, cameras "
              f"{c_diff} (<= 1e-4), points {p_diff} (<= 1e-5)")
        lines.append(f"(i) one batched solve {t_batched:.3f} s against {B} unbatched "
                     f"{t_unbatched:.3f} s (each timed alone after a warm-up)")

        # (j) frame-sharded triangulation over two entries (T=15 padded to 16)
        R, tvec, intr, _ = geometry.calib_to_arrays({c: golden_3d[c] for c in range(7)}, 7)
        p2 = np.concatenate([golden_3d["points2d"], golden_3d["points2d"][:, :1]], axis=1)
        tri = pipeline.make_sharded_triangulate(mesh.data_mesh(devices=[dev, dev]), (960, 480))
        out = tri(torch.from_numpy(p2).to(dev), *(torch.from_numpy(a).to(dev)
                                                  for a in (R, tvec, intr)))
        T = golden_3d["points2d"].shape[1]
        j_diff = float(np.abs(out.cpu().numpy()[:T] - golden_3d["points3d_wo_procrustes"]).max())
        if out.shape != (T + 1, 38, 3) or j_diff > 1e-5:
            raise AssertionError(f"(j) sharded triangulation {tuple(out.shape)}, vs golden {j_diff}")
        print(f"(j) make_sharded_triangulate over 2 entries, the {T} golden frames padded to "
              f"{T + 1}, float64 svd on the card: points3d_wo_procrustes within {j_diff} "
              f"(<= 1e-5)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, lines


def k5_batch(np):
    """(l)'s inputs: golden frame 0 of the K5_CAMERAS (uint8), their flips,
    and the golden targets at 64x128 (sigma 1.25, the script's)."""
    from deepfly3d_torch.models import train as train_mod

    with np.load(os.path.join(ROOT, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        frames, order = z["frames"], list(z["camera_ordering"])
    with open(os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"),
              "rb") as fh:
        golden = pickle.load(fh)
    coords, peaks, known = train_mod.golden_training_targets(
        golden["points2d"], golden["heatmap_confidence"], order)
    cams = list(K5_CAMERAS)
    flips = np.asarray([order.index(c) > 3 for c in cams])
    targets, cells = train_mod.render_target_heatmaps(
        coords[cams, 0], peaks[cams, 0], known[cams, 0], (64, 128), sigma=1.25)
    return frames[cams], flips, targets, cells, peaks[cams, 0].astype(np.float32)


def _leaf(np, tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def k5_trajectory(torch, np, device):
    """(l): the port's 5 steps (preprocess kernel on a card) -> (per-step
    [loss, mse, peak_err], {leaf: array})."""
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.models import train as train_mod
    from deepfly3d_torch.ops import image as image_ops

    frames, flips, targets, cells, peaks = k5_batch(np)
    variables, spec = hg.load_weights(os.path.join(ROOT, "weights", CONV))
    x = image_ops.preprocess_frames(torch.from_numpy(frames).to(device),
                                    torch.from_numpy(flips).to(device), (256, 512))
    net = hg.trainable(variables, spec, device=device)
    tx = train_mod.adam(K5_LR)
    opt_state = tx(net.parameters())
    epoch = train_mod.make_train_epoch(spec, tx, 100.0, 1, len(frames), freeze_bn=True)
    rng = torch.Generator(device=device).manual_seed(0)
    losses = [epoch(net, opt_state, rng, x, torch.from_numpy(targets).to(device),
                    torch.from_numpy(cells).long().to(device), torch.from_numpy(peaks).to(device))
              for _ in range(5)]
    out = hg.module_variables(net)
    return np.asarray(losses), {k: _leaf(np, out, k) for k in K5_LEAVES}


def k5_check(np, losses, leaves, ref):
    """(l)'s tolerances, the CPU test's (tests/test_torch_train.py).

    Adam divides each element's step by the root of its squared gradient, so
    an element whose gradient is at rounding level steps by ~lr in a
    direction that rounding decides, in either package and on either device
    (ROADMAP Queue 3).  Hence, after the first update, a share of the
    parameters differs by up to lr per step and the losses follow them.
    Losses ([loss, mse, peak_err] per step): the first step's, computed at
    the checkpoint, rtol 1e-4 (each package's resize, 2e-6 apart, and f32
    convolutions in another order: 5.2e-5 measured on the CPU, 5.0e-5 on the
    card); mse after an update rtol 1e-3 (CPU 5.2e-5, card 2.1e-4); loss and
    peak_err after an update rtol 5e-3, as they follow single cells, the
    worst offender and the maximum (CPU 1.1e-4, card 2.0e-3).  Parameters:
    every element within 2 * lr per step (Adam's step), and at most 1% of a
    leaf's elements beyond 2e-5 of its largest magnitude (CPU 0.01%, card
    0.3%).  The frozen batch statistics are unchanged: equal.  Card figures:
    NVIDIA H100 80GB HBM3, 700 W.  Raises AssertionError listing every
    violation.  -> the largest differences, for the record.
    """
    want = ref["losses"]
    rel = np.abs(losses - want) / np.abs(want)
    worst = {"first_step_rel": float(rel[0].max()), "mse_rel": float(rel[1:, 1].max()),
             "loss_peak_rel": float(rel[1:][:, [0, 2]].max())}
    bad = [f"losses {name} {worst[name]}" for name, tol in
           (("first_step_rel", 1e-4), ("mse_rel", 1e-3), ("loss_peak_rel", 5e-3))
           if not worst[name] <= tol]
    for k in K5_LEAVES:
        if k.startswith("batch_stats/"):
            if not np.array_equal(leaves[k], ref[k]):
                bad.append(f"{k} changed")
            continue
        diff = np.abs(leaves[k] - ref[k])
        beyond = int((diff > 2e-5 * max(1.0, float(np.abs(ref[k]).max()))).sum())
        worst[k] = [float(diff.max()), beyond, int(diff.size)]
        if diff.max() > 2 * K5_LR * 5 or beyond > 1e-2 * diff.size:
            bad.append(f"{k}: max diff {diff.max()}, {beyond} of {diff.size} beyond 2e-5")
    if bad:
        raise AssertionError(f"5-step trajectory off JAX's: {bad}; measured {worst}")
    return worst


def seeded_block(np, cin, cmid, cout):
    """A projecting block's params and batch statistics from seed 0."""
    rng = np.random.default_rng(0)

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c), "bias": 0.1 * rng.standard_normal(c)},
                {"mean": 0.1 * rng.standard_normal(c), "var": rng.uniform(0.5, 1.5, c)})

    def conv(k, ci, co):
        return {"kernel": rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci),
                "bias": 0.1 * rng.standard_normal(co)}

    (p1, s1), (p2, s2), (p3, s3) = bn(cin), bn(cmid), bn(cmid)
    params = {"bn1": p1, "bn2": p2, "bn3": p3, "conv1": conv(1, cin, cmid),
              "conv2": conv(3, cmid, cmid), "conv3": conv(1, cmid, cout),
              "proj": conv(1, cin, cout)}
    return params, {"bn1": s1, "bn2": s2, "bn3": s3}


def raw_block(np, torch, dev, params, stats):
    """One block's fold with the raw-input projection, packed, on ``dev``."""
    from deepfly3d_torch.ops import bottleneck as bn

    f = bn.add_packed(bn.fold_bottleneck(params, stats, proj_from_raw=True))
    return {k: v.to(dev) for k, v in f.items()}


def train_phase(torch, np, dev, card, counters, converted):
    """(k)-(o) on the card; ``converted`` is the conv checkpoint read as a
    checkpoint converted from torch (proj_from_raw), as a pipeline.
    -> ({path: launches}, informational lines)."""
    import io

    from deepfly3d_torch import train_fly_weights
    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.models import train as train_mod
    from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.parallel import mesh as mesh_mod
    from deepfly3d_torch.parallel import pipeline as par
    from deepfly3d_torch.pipeline import plain_twin

    launches, lines = {}, []
    variables, spec = hg.load_weights(os.path.join(WEIGHTS_DIR, CONV))
    with np.load(os.path.join(ROOT, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        frames0, order = z["frames"], list(z["camera_ordering"])
    flips0 = torch.from_numpy(np.isin(np.arange(7), order[4:])).to(dev)

    # (k) the trainable network's eval forward (cuDNN, TF32 off) against the
    # folded forward through the kernels, golden frame 0 of the 7 cameras
    x0 = image_ops.preprocess_frames(torch.from_numpy(frames0).to(dev), flips0, (256, 512))
    net = hg.trainable(variables, spec, dev)
    folded = FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev)
    with torch.no_grad():
        want, got = net(x0)[-1], folded(x0)[-1]
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        hm_err = (got - want).abs().max().item()
        (pts_t, conf_t), (pts_k, conf_k) = (kernels.decode_heatmaps(h) for h in (want, got))
        conf_err = (conf_t - conf_k).abs().max().item()
        if hm_err > TRAIN_HM_TOL * scale or conf_err > 2e-5 or not torch.equal(pts_t, pts_k):
            raise AssertionError(f"(k) trainable vs folded forward: heatmaps {hm_err} (of "
                                 f"{scale}), conf {conf_err}, cells equal "
                                 f"{torch.equal(pts_t, pts_k)}")
        t_cudnn = cuda_ms(torch, lambda: net(x0), iters=5)
        t_kernels = cuda_ms(torch, lambda: folded(x0), iters=5)
    print(f"(k) golden frame 0, 7 images at 256x512: the trainable net's eval forward "
          f"(cuDNN f32) against the folded kernels: heatmaps max diff {hm_err} (magnitude "
          f"{scale:.3f}, tolerance {TRAIN_HM_TOL} of it), conf {conf_err}, the same cells; "
          f"informational: {t_cudnn:.3f} ms (cuDNN, unfolded) against {t_kernels:.3f} ms "
          f"(kernels) per forward, on {card}")
    del net, folded

    # (o) a checkpoint converted from torch (proj_from_raw) served through the
    # kernels' raw-projection instances, against its plain twin
    frames = converted.frames
    (pts3d, p38, conf), got = count_launches(torch, counters, lambda: converted.pipe(frames))
    if got != EXPECTED["conv"]:
        raise AssertionError(f"(o) converted path launches {got}, want {EXPECTED['conv']}")
    launches["converted"] = got
    q3d, q38, qconf = plain_twin(converted.pipe)(frames)
    torch.cuda.synchronize()
    conf_diff = (conf - qconf).abs().max().item()
    if not torch.equal(p38, q38) or conf_diff > 1e-4 or not torch.isfinite(pts3d).all():
        raise AssertionError(f"(o) converted path vs plain: p38 equal {torch.equal(p38, q38)}, "
                             f"conf {conf_diff}")
    print(f"(o) the conv checkpoint as a converted one (proj_from_raw) at T={BATCH_T}: "
          f"launches {got}; vs plain: p38 equal, conf max diff {conf_diff}")

    # (l) the committed 5-step trajectory
    with np.load(os.path.join(ROOT, K5_REF)) as z:
        ref = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    losses, leaves = k5_trajectory(torch, np, dev)
    worst = k5_check(np, losses, leaves, ref)
    print(f"(l) 5 frozen-statistics steps of the conv checkpoint on {len(K5_CAMERAS)} golden "
          f"images against JAX's trajectory: losses {losses[:, 0].tolist()} (JAX "
          f"{ref['losses'][:, 0].tolist()}); largest differences {json.dumps(worst)}; "
          f"{time.perf_counter() - t0:.1f} s")

    # (m) the training script, resumed from the conv checkpoint in a temporary
    # folder; its evals run the serving path through the kernels
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_train_")
    try:
        out = os.path.join(tmp, CONV)
        shutil.copy(os.path.join(WEIGHTS_DIR, CONV), out)
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, got = count_launches(torch, counters, lambda: train_fly_weights.main(
                SCRIPT_ARGS + ["--out", out]))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        text = buf.getvalue()
        print("\n".join("  train_fly_weights: " + line for line in text.splitlines()
                        if not line.startswith("{'step'")))
        # 3 preprocess launches (the inputs and two evals: step 200 and the
        # final one), 31 bottleneck, 8 upsample-add and 1 decode per eval
        want = {"fused_bottleneck": 62, "upsample2x_add": 16, "decode_heatmaps": 2,
                "preprocess_resize": 3}
        if got != want or rc not in (0, 1) or not os.path.exists(out):
            raise AssertionError(f"(m) train_fly_weights: rc {rc}, launches {got} (want {want})")
        launches["train_script"] = got
        seconds = float(text.split("training took ")[1].split("s")[0])
        final = text.split("final (after BN recalibration): ")[1].splitlines()[0]
        steps = int(SCRIPT_ARGS[SCRIPT_ARGS.index("--steps") + 1])
        batch = int(SCRIPT_ARGS[SCRIPT_ARGS.index("--batch-size") + 1])
        hg.load_weights(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines.append(f"(m) python -m deepfly3d_torch.train_fly_weights {' '.join(SCRIPT_ARGS)}: "
                 f"exit {rc}, {steps / seconds:.2f} steps/s, {steps * batch / seconds:.1f} "
                 f"images/s ({seconds:.1f} s of training with one eval, {wall:.1f} s in all), "
                 f"peak memory {peak / 2**30:.2f} GiB, golden {final}; launches {got}")
    print("informational: " + lines[-1] + f", on {card}")

    # (n) the data-parallel step at full width: one entry, two entries on this
    # card, and the one-device step (Adam eps 10, as the CPU test)
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(SHARDED_BATCH, 256, 512, 3)).astype(np.float32)
    ts = rng.uniform(size=(SHARDED_BATCH, 64, 128, 19)).astype(np.float32)
    init = hg.init_params(spec, (256, 512), torch.Generator(device=dev).manual_seed(0), dev)

    def sharded(entries):
        init_fn, step_fn = par.make_sharded_train_step(spec, mesh_mod.data_mesh(
            devices=[dev] * entries))
        params, stats, opt = init_fn(0, (256, 512))
        with torch.no_grad():
            _copy_tree(params, init["params"])
            _copy_tree(stats, init["batch_stats"])
        for group in opt.param_groups:
            group["eps"] = 10.0
        out = []
        for _ in range(2):
            params, stats, opt, loss = step_fn(params, stats, opt, xs, ts)
            out.append(loss.item())
        return out, params

    def one_device():
        net = hg.trainable(init, spec, dev)
        opt = train_mod.adam(1e-3, eps=10.0)(net.parameters())
        x, t = torch.from_numpy(xs).to(dev), torch.from_numpy(ts).to(dev)
        out = []
        for _ in range(2):
            loss = ((net(x, train=True) - t[None]) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            out.append(loss.item())
        return out, hg.module_variables(net)["params"]

    t0 = time.perf_counter()
    runs = {"1 entry": sharded(1), "2 entries on one card": sharded(2),
            "one device": one_device()}
    base_losses, base_params = runs["one device"]
    diffs = {}
    for name, (losses_n, params_n) in runs.items():
        a = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
             for k, v in _flat(params_n).items()}
        b = _flat(base_params)
        d = max(float(np.abs(a[k] - b[k]).max()) for k in b)
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses_n, base_losses))
        diffs[name] = (rel, d)
        if rel > 1e-5 or d > 1e-5:
            raise AssertionError(f"(n) {name}: losses rel {rel}, parameters {d} off the "
                                 f"one-device step")
    print(f"(n) make_sharded_train_step at full width, batch {SHARDED_BATCH}, 2 steps: losses "
          f"{runs['1 entry'][0]}; against the one-device step (losses rel, parameters abs): "
          f"{json.dumps(diffs)}; {time.perf_counter() - t0:.1f} s")
    return launches, lines


def train_step_call(torch, np, dev, spec=None):
    """``--profile``'s training path: one BN-training Adam step of the conv
    checkpoint at TRAIN_BATCH on seeded inputs (the script's loss weights),
    warmed up once, at its own spec or at ``spec``.  -> the call."""
    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.models import train as train_mod

    variables, own = hg.load_weights(os.path.join(WEIGHTS_DIR, CONV))
    spec = spec or own
    net = hg.trainable(variables, spec, dev)
    tx = train_mod.adam(1e-4)
    opt_state = tx(net.parameters())
    epoch = train_mod.make_train_epoch(spec, tx, 100.0, 1, TRAIN_BATCH, noise_scale=0.008)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(TRAIN_BATCH, 256, 512, 3)).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(size=(TRAIN_BATCH, 64, 128, 19)).astype(np.float32)).to(dev)
    cells = torch.from_numpy(rng.integers(0, 64, size=(TRAIN_BATCH, 19, 2))).to(dev)
    peaks = torch.from_numpy(rng.uniform(0.3, 0.9, size=(TRAIN_BATCH, 19)).astype(
        np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call():
        return epoch(net, opt_state, gen, x, t, cells, peaks)

    call()
    return call


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _copy_tree(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree(v, src[k])
        else:
            v.copy_(src[k])


# phase 12: the bf16 paths at full width, T=8, rig on, each named by its
# configuration (BF16_CONFIGS, or the bf16 cascade), and their launches per
# call (the bf16 instances apart)
BF16_PATHS = {"conv_bf16": "hourglass_fly_tpu", "p16_bf16": "hourglass_fly_p16_tpu",
              "cascade_bf16": "cascade",
              "p16_bf16_preprocess": "hourglass_fly_p16_tpu+bf16_preprocess"}
BF16_EXPECTED = {
    "conv_bf16": {"fused_bottleneck_bf16": 31, "upsample2x_add_bf16": 8, "decode_heatmaps": 1,
                  "preprocess_resize": 1},
    "p16_bf16": {"fused_bottleneck_bf16": 16, "upsample2x_add_bf16": 4, "decode_heatmaps": 1,
                 "preprocess_resize": 1},
    "cascade_bf16": {"fused_bottleneck_bf16": 16 + 31, "upsample2x_add_bf16": 4 + 8,
                     "decode_heatmaps": 2, "preprocess_resize": 2},
    "p16_bf16_preprocess": {"fused_bottleneck_bf16": 16, "upsample2x_add_bf16": 4,
                            "decode_heatmaps": 1, "preprocess_resize_bf16": 1},
}
BF16_BLOCK_ULPS = 2     # kernel vs plain, in bf16 ulps of the block output's largest magnitude
PEAK_BF16_FLOPS = 989e12


# a wrapper's launch counters and the kernel name each counts under (the
# bottleneck's general instance since phase 13)
COUNTERS = {"launches": "", "launches_128": "_128", "launches_bf16": "_bf16",
            "launches_general": "_general", "launches_general_bf16": "_general_bf16"}


def counts_with_bf16(wrappers):
    """{kernel name: launches}: each wrapper's counters, the bf16 instance's
    launches under name + "_bf16", the general instance's under name +
    "_general" and name + "_general_bf16"."""
    return {fn.__name__ + suffix: getattr(fn, attr)
            for fn in wrappers for attr, suffix in COUNTERS.items() if hasattr(fn, attr)}


def zero_counts(wrappers):
    for fn in wrappers:
        for attr in COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def bf16_ulps(np, got, want):
    """-> (share of elements that differ, max difference in bf16 ulps of
    ``want``'s largest magnitude); float32 numpy arrays of bf16 values."""
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 2.0 ** -133
    return float((got != want).mean()), float(np.abs(got - want).max() / ulp)


def device_ms(torch, call, table=None):
    """Device time of one ``call()`` (torch.profiler: the CUDA kernels' own
    time) -> (ms, the five kernels that took most, as (name, ms)); with a
    ``table`` file, the profiler's table is appended to it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if table is not None:
        with open(table, "a") as fh:
            fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            [(e.key[:60], round(e.self_device_time_total / 1e3, 3)) for e in top])


def bf16_twin_check(torch, np, dev, what, pipe, twin, frames, weights_of, out, twin_out):
    """A bf16 pipeline against its plain twin under phase 12's rule: each net
    against its twin's on the same input (the path's preprocessed frames) at
    the forward bound (heatmaps within BF16_HEATMAP_TOL of their magnitude,
    conf within ``bf16_conf_tol`` of the twin's gap to the float32 net of the
    same weights, ``weights_of(attr)``, through the float32 kernels; the same
    cells wherever the twin's top-2 margin exceeds twice the 5e-3 peak bound),
    and the path's outputs ``out`` = (p38, conf) against ``twin_out``.
    Raises otherwise."""
    from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass

    p38, conf = out
    q38, qconf = twin_out
    # each net against its twin's on the same input: the forward bound, and
    # the cells against what bf16 rounding moves (the twin against the
    # float32 net of the same checkpoint, through the float32 kernels)
    x_u8, flip, reg, _, _ = pipe._register(frames)
    allowed_all, conf_spread, notes = 0, 0.0, []
    for attr, net in pipe.nets().items():
        shape = pipe.teacher_shape if attr == "teacher" else pipe.input_shape
        x = pipe.preprocess(x_u8, flip, shape, net.spec.preprocess_dtype,
                            shift=None if reg is None else reg[:2],
                            gain=None if reg is None else reg[2])
        spec32 = dataclasses.replace(net.spec, compute_dtype="float32")
        net32 = FoldedHourglass(fold_hourglass(weights_of(attr), spec32), spec32).to(dev).eval()
        with torch.inference_mode():
            hk = net(x)[-1].float().cpu().numpy()
            hp = twin.nets()[attr](x)[-1].float().cpu().numpy()
            hf = net32(x)[-1].float().cpu().numpy()
        del net32
        err = float(np.abs(hk - hp).max() / np.abs(hp).max())
        (ck, confk, _), (cp, confp, mp) = decode_np(np, hk), decode_np(np, hp)
        cf, conff, _ = decode_np(np, hf)
        # two bf16 forwards may part only where the twin's top-2 margin is
        # within the peak differences the confidence bound admits, on both cells
        n_diff, spread = int((ck != cp).sum()), int((cf != cp).sum())
        n_kf, allowed = int((ck != cf).sum()), 2 + 2 * spread
        allowed_all += allowed
        conf_err = float(np.abs(confk - confp).max())
        gap = float(np.abs(conff - confp).max())
        conf_spread = max(conf_spread, gap)
        decided = int(((ck != cp) & (mp > 2 * BF16_CONF_TOL)).sum())
        notes.append(f"{attr}: heatmaps {err:.4f} of their magnitude, conf {conf_err:.2e} "
                     f"(allowed {bf16_conf_tol(gap):.2e}: the float32 net's {gap:.2e}); "
                     f"kernels and twin differ at {n_diff} of {ck.size} cells, at {decided} "
                     f"where the twin's top-2 margin exceeds {2 * BF16_CONF_TOL} (the margin "
                     f"there up to {float(mp[ck != cp].max()) if n_diff else 0.0:.2e}); the "
                     f"float32 net's cells left by the kernels at {n_kf}, by the twin at "
                     f"{spread}")
        print(f"{what} vs plain, same input: {notes[-1]}")
        if err > BF16_HEATMAP_TOL or decided or conf_err > bf16_conf_tol(gap):
            raise AssertionError(f"{what} vs plain: {notes[-1]}")
    # the outputs: the preprocess kernel's float32 sums differ from the plain
    # version's at the last bit, which a bf16 net's first rounding can amplify
    conf_diff = float((conf - qconf).abs().max())
    n_diff = int((p38 != q38).any(-1).sum())
    if conf_diff > bf16_conf_tol(conf_spread) or n_diff > allowed_all:
        raise AssertionError(f"{what} vs plain: conf {conf_diff} (allowed "
                             f"{bf16_conf_tol(conf_spread)}), {n_diff} p38 entries differ "
                             f"(allowed {allowed_all})")
    print(f"{what} vs plain on the card: output conf max diff {conf_diff} (allowed "
          f"{bf16_conf_tol(conf_spread)}), {n_diff} p38 entries differ (allowed "
          f"{allowed_all})")


def bf16_phase(torch, np, F, dev, card, ckpt, calib, order, frames, ref0, rows, checks, record,
               shape_rows, gen, profile=None):
    """Phase 12: the bfloat16 serving path.  -> ({path: launches}, informational
    lines, the kernel-phase checks of the bf16 instances by kernel name).

    (p) the four bf16 paths' plain twins record every shape they give each
    kernel; (q) the kernel phase at bf16 at every recorded shape and at the
    h36m network's 128-wide block shapes (seeded weights, its batch of 8):
    the bottleneck within BF16_BLOCK_ULPS of its plain version, upsample-add
    bit-equal, the bf16-output preprocess within one ulp of each element (the
    float32 kernels at the shapes the bf16 paths give them, as in phase 4);
    (r) each path once with every launch count set to 0 just before and read
    just after: the recorded counts, the bf16 instances only; each net's
    heatmaps and confidences against its plain twin's on the same input at
    the forward bound (the confidence bound taken from the twin against the
    float32 net of the same checkpoint, ``bf16_conf_tol``), and its cells:
    the same wherever the twin's top-2 margin exceeds twice the 5e-3 peak
    bound (two bf16 forwards part only at near-ties); the path's output
    against the twin's; frames/s and device ms per call beside the float32
    path of the same checkpoints (with ``profile``, a file, the profiler's table of each is
    appended to it); (s) golden frame 0 (rig off) through every bf16 configuration
    and the bf16 cascade: the plain twin on the card against the JAX
    package's bf16 results (``BF16_REF``, ``bf16_cells_check``), the kernels
    within 5e-3 of JAX's confidences and with no more differing cells than
    the twin's allowance plus the cells in which the kernels leave the twin;
    the golden errors of frame 0 beside the JAX package's CPU errors on the
    15 golden frames.
    """
    import copy

    from deepfly3d_torch.models.cascade import build_cascade_pipeline
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin

    wrappers = (bn.fused_bottleneck, kernels.upsample2x_add, kernels.decode_heatmaps,
                kernels.preprocess_resize)
    counted = tuple(counts_with_bf16(wrappers))

    def bf16_spec(key, bf16=True):
        _, spec = ckpt[key.split("+")[0] + ".npz"]
        if not bf16:                                    # the checkpoint's float32 path
            return spec
        return dataclasses.replace(spec, compute_dtype="bfloat16", **BF16_CONFIGS[key])

    def checkpoint_of(path, attr):
        key = BF16_PATHS[path]
        if key == "cascade":
            return STUDENT if attr == "net" else CONV
        return key.split("+")[0] + ".npz"

    def build(key, rig, bf16=True):
        if key == "cascade":
            return build_cascade_pipeline(
                ckpt[STUDENT][0], bf16_spec(STUDENT[:-len(".npz")], bf16), ckpt[CONV][0],
                bf16_spec(CONV[:-len(".npz")], bf16), calib, order, rig=rig, device=dev)
        return build_pipeline(bf16_spec(key, bf16), ckpt[key.split("+")[0] + ".npz"][0], calib,
                              order, rig=rig, device=dev)

    pipes = {path: build(key, "auto") for path, key in BF16_PATHS.items()}
    # (p) the shapes
    rows16 = {}
    for path, pipe in pipes.items():
        record_shapes(plain_twin(pipe), path, rows16, lambda twin: twin(frames))

    # (q) the kernel phase at bf16
    def check_bottleneck(key, counts, f):
        record("fused_bottleneck_bf16",
               bottleneck_row(torch, np, F, dev, gen, key, f, "bfloat16"), counts)

    def check_merge(key, counts):
        n, h, w, c = key
        inner = torch.randn(key, generator=gen).to(dev).to(torch.bfloat16)
        skip = torch.randn((n, 2 * h, 2 * w, c), generator=gen).to(dev).to(torch.bfloat16)
        out = kernels.upsample2x_add(inner, skip)
        ref = kernels.upsample2x_add_plain(inner, skip)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"bf16 upsample2x_add {key}: not bit-equal to its plain version")
        nbytes = 2.0 * (inner.numel() + 2 * skip.numel())
        b_ms, b_by = bound_ms(float(skip.numel()), nbytes)
        record("upsample2x_add_bf16", {
            "shape": list(key), "max_abs_err": 0.0,
            **times(torch, lambda: kernels.upsample2x_add(inner, skip),
                    lambda: kernels.upsample2x_add_plain(inner, skip),
                    lambda: skip + inner.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": float(skip.numel()), "bytes": nbytes},
            counts)

    def check_preprocess(key, counts):
        n, h_in, w_in, c, h, w = key
        x = torch.randint(0, 256, (n, h_in, w_in, c), generator=gen, dtype=torch.uint8).to(dev)
        flip = (torch.arange(n) % 3 == 1).to(dev)
        dy, dx = (torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
                  for _ in range(2))
        gain = 0.9 + 0.2 * torch.rand(n, generator=gen)
        gain[::4] = 1.0
        gain = gain.to(dev)

        def kernel():
            return kernels.preprocess_resize(x, flip, (h, w), shift=(dy, dx), gain=gain,
                                             dtype="bfloat16")

        def plain():
            return image_ops.preprocess_frames_plain(x, flip, (h, w), "bfloat16", shift=(dy, dx),
                                                     gain=gain)

        def unfused():           # the registration as separate steps around the kernel
            rolled = image_ops.roll_frames(x, (dy, dx))
            bare = kernels.preprocess_resize(rolled, flip, (h, w), dtype="bfloat16")
            return (bare.float() * gain.to(torch.bfloat16).float()[:, None, None, None]
                    ).to(torch.bfloat16)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, unfused()):
            raise AssertionError(f"bf16 preprocess {key}: the fused shift and gain differ from "
                                 f"the kernel on rolled frames times the bf16 gain")
        got, want = out.float().cpu().numpy(), ref.float().cpu().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        if not (np.abs(got - want) <= ulp).all():
            raise AssertionError(f"bf16 preprocess {key}: more than one ulp off its plain version")

        def library():       # the same triangle filter (it has no bf16 antialiased
            # instance: float32, the result cast to bf16), flip and bf16 gain
            xc = (image_ops.roll_frames(x, (dy, dx)).float() * (1.0 / 255.0)).permute(0, 3, 1, 2)
            y = F.interpolate(xc, size=(h, w), mode="bilinear", antialias=True,
                              align_corners=False).permute(0, 2, 3, 1).to(torch.bfloat16)
            y = torch.where(flip.reshape(n, 1, 1, 1), y.flip(2), y)
            return y * gain.to(torch.bfloat16)[:, None, None, None]

        kh = image_ops.resize_taps(h_in, h, 1.0 / 255.0)[1].shape[1]
        kw = image_ops.resize_taps(w_in, w, 1.0)[1].shape[1]
        flops = 2.0 * n * c * (h * w_in * kh + h * w * kw) + n * h * w * c
        nbytes = float(x.numel() + 2 * out.numel() + 13 * n + 8 * (h * kh + w * kw)
                       + 4 * (h + w))
        b_ms, b_by = bound_ms(flops, nbytes)
        record("preprocess_resize_bf16", {
            "shape": list(key), "taps": [kh, kw],
            "instance": kernels.preprocess_instance_for(x, out),
            "max_abs_err": float(np.abs(got - want).max()),
            "share_differing": float((got != want).mean()),
            "library_err": (library().float() - ref.float()).abs().max().item(),
            **times(torch, kernel, plain, library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}, counts)

    bf16_checks = {"fused_bottleneck_bf16": check_bottleneck, "upsample2x_add_bf16": check_merge,
                   "preprocess_resize_bf16": check_preprocess,
                   "decode_heatmaps": checks["decode_heatmaps"],
                   "preprocess_resize": checks["preprocess_resize"]}
    for (kernel, key), row in sorted(rows16.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        if kernel == "fused_bottleneck_bf16":
            check_bottleneck(key, row["counts"], row["extra"])
        elif kernel in bf16_checks:
            bf16_checks[kernel](key, row["counts"])
        else:
            raise AssertionError(f"a bf16 path gave the float32 kernel {kernel} the shape {key}")
        torch.cuda.empty_cache()
    # the h36m network's 128-wide blocks at its batch of 8, seeded; on no bf16 path
    h36m_blocks = sorted({key for (kernel, key), row in rows.items()
                          if kernel == "fused_bottleneck_128" and row["counts"]["h36m"]
                          and 128 in (key[3], key[5]) and not key[7]})
    for key in h36m_blocks:
        params, stats = seeded_block(np, key[3], key[4], key[5])
        if not key[6]:
            params.pop("proj")
        f = bn.add_packed(bn.fold_bottleneck(params, stats, dtype="bfloat16"))
        check_bottleneck((8,) + key[1:], {}, {k: v.to(dev) for k, v in f.items()})
    print(json.dumps({"bf16_kernel_shapes": [r for r in shape_rows
                                             if r["kernel"].endswith("_bf16")]}))

    # (r) each path once, counted, against its plain twin
    launches, lines = {}, []

    def fps(p, iters=5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            p(frames)
        torch.cuda.synchronize()
        return BATCH_T * iters / (time.perf_counter() - t)

    for path, pipe in pipes.items():
        zero_counts(wrappers)
        torch.cuda.synchronize()
        pts3d, p38, conf = pipe(frames)
        torch.cuda.synchronize()
        got = counts_with_bf16(wrappers)
        want = {k: BF16_EXPECTED[path].get(k, 0) for k in counted}
        recorded = {k: sum(row["counts"][path] for (kernel, _), row in rows16.items()
                           if kernel == k) for k in counted}
        if got != want or got != recorded:
            raise AssertionError(f"{path} launches {got}, want {want} (recorded {recorded})")
        launches[path] = got
        print(f"bf16 slice {path} launches: {got}")
        num_cameras = p38.shape[0]
        if not (torch.isfinite(pts3d).all() and pts3d.shape == (BATCH_T, 38, 3)
                and conf.shape == (num_cameras, BATCH_T, 19, 1)):
            raise AssertionError(f"{path} outputs have the wrong shape or are not finite")
        twin = plain_twin(pipe)
        before = counts_with_bf16(wrappers)
        q3d, q38, qconf = twin(frames)
        torch.cuda.synchronize()
        if counts_with_bf16(wrappers) != before:
            raise AssertionError(f"the plain {path} pipeline launched a kernel")
        if path == "cascade_bf16" and not torch.equal(pipe.last_repaired, twin.last_repaired):
            raise AssertionError("the bf16 cascade repaired other images than its plain twin")
        bf16_twin_check(torch, np, dev, f"bf16 slice {path}", pipe, twin, frames,
                        lambda attr, path=path: ckpt[checkpoint_of(path, attr)][0],
                        (p38, conf), (q38, qconf))
        f32_pipe = build(BF16_PATHS[path], "auto", bf16=False)
        pipe(frames), f32_pipe(frames)                          # warm both
        turns = [(fps(f32_pipe), fps(pipe)) for _ in range(2)]   # f32, bf16, f32, bf16
        if profile is not None:
            with open(profile, "a") as fh:
                fh.write(f"\n==== {path} path and the float32 path of its checkpoints, one "
                         f"call each at T={BATCH_T}\n")
        dms = (device_ms(torch, lambda: f32_pipe(frames), profile),
               device_ms(torch, lambda: pipe(frames), profile))
        lines.append(f"informational: {path} frames/s in turns (T={BATCH_T}, frames on the card) "
                     f"bf16 {[b for _, b in turns]} against float32 {[a for a, _ in turns]} "
                     f"(the same checkpoints); device ms per call (torch.profiler) bf16 "
                     f"{dms[1][0]:.3f} against float32 {dms[0][0]:.3f}; the kernels that took most "
                     f"(ms) bf16 {dms[1][1]}, float32 {dms[0][1]}; on {card}")
        print(lines[-1])

    # (s) golden frame 0 against the JAX package's bf16 results
    with open(os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"),
              "rb") as fh:
        golden = pickle.load(fh)
    with np.load(os.path.join(ROOT, BF16_REF)) as z:
        ref = {k: z[k] for k in z.files}
    in_slice = {key: path for path, key in BF16_PATHS.items()}
    for key in list(BF16_CONFIGS) + ["cascade"]:
        if key in in_slice:
            pipe = copy.copy(pipes[in_slice[key]])
            pipe.rig = None
        else:
            pipe = build(key, None)
        _, g38, gconf = pipe(ref0["frames"][None])
        _, t38, tconf = plain_twin(pipe)(ref0["frames"][None])
        g38, gconf, t38, tconf = (a.cpu().numpy() for a in (g38, gconf, t38, tconf))
        if key == "cascade":
            margin = ref[f"{STUDENT[:-4]}/flax/margin"].copy()
            rep = int(pipe.last_repaired[0])
            margin[rep] = ref[f"{CONV[:-4]}/flax/margin"][rep]
            spread = sum(int((ref[f"{k[:-4]}/flax/f32_cells"] != ref[f"{k[:-4]}/flax/cells"]).sum())
                         for k in (STUDENT, CONV))
            conf_tol = bf16_conf_tol(max(np.abs(ref[f"{k[:-4]}/flax/f32_conf"]
                                                - ref[f"{k[:-4]}/flax/conf"]).max()
                                         for k in (STUDENT, CONV)))
            want38, jconf = ref["cascade/p38"], ref["cascade/conf"][:, 0, :, 0]
        else:
            kind = "fused" if key == CONV[:-4] else "flax"
            cells, jconf, margin = (ref[f"{key}/{kind}/{a}"] for a in ("cells", "conf", "margin"))
            spread = int((ref[f"{key}/flax/f32_cells"] != ref[f"{key}/flax/cells"]).sum())
            conf_tol = bf16_conf_tol(np.abs(ref[f"{key}/flax/f32_conf"]
                                            - ref[f"{key}/flax/conf"]).max())
            want38 = cells_p38(np, cells, order, tuple(v // 4 for v in pipe.input_shape))
        t_diff, allowed, excluded = bf16_cells_check(np, f"bf16 golden frame 0, {key}, plain",
                                                     t38, want38, margin, spread, order)
        kt_diff = int((np.abs(g38 - t38) > CELL_ATOL).any(-1).sum())
        n_diff = int((np.abs(g38 - want38) > CELL_ATOL).any(-1).sum())
        conf_err = float(np.abs(gconf[:, 0, :, 0] - jconf).max())
        t_conf_err = float(np.abs(tconf[:, 0, :, 0] - jconf).max())
        if n_diff > allowed + kt_diff or max(conf_err, t_conf_err) > conf_tol:
            raise AssertionError(f"bf16 golden frame 0, {key}: {n_diff} cells differ from JAX "
                                 f"(allowed {allowed} + the {kt_diff} where the kernels leave "
                                 f"the plain twin), conf vs JAX {conf_err} (plain {t_conf_err})")
        pts_err = float(np.abs(g38 - golden["points2d"][:, :1]).max())
        g_conf_err = float(np.abs(gconf - golden["heatmap_confidence"][:, :1]).max())
        cpu = ref.get(f"golden/{key.split('+')[0]}/bfloat16")
        print(f"bf16 golden frame 0, {key}: the kernels' cells differ from JAX's bf16 at "
              f"{n_diff}, the plain twin's at {t_diff} (allowed {allowed}; {excluded:.3f} of the "
              f"image-joints within the {BF16_MARGIN} margin), the kernels leave the twin at "
              f"{kt_diff}; conf vs JAX {conf_err:.2e} (plain {t_conf_err:.2e}, <= "
              f"{conf_tol:.2e}); informational: pts_err {pts_err}, conf_err "
              f"{g_conf_err} on frame 0"
              + ("" if cpu is None else f" (the JAX package on the CPU, 15 frames: pts_err "
                                        f"{cpu[0]}, conf_err {cpu[1]})"))
    return launches, lines, bf16_checks


# phase 13: the converter's default output, a 256-wide checkpoint (the df2d
# sh8 lineage: 2 stacks, depth 4, 19 joints, 256x512, proj_from_raw), from a
# seeded torch state dict under the sh8 names at a trained net's scale (heatmap
# peaks ~2, utils/synthetic.random_checkpoint), served at T=8 with the rig on;
# every block runs the bottleneck kernel's general instance
WIDE_SEED = 0
WIDE_EXPECTED = {"fused_bottleneck_general": 31, "upsample2x_add": 8, "decode_heatmaps": 1,
                 "preprocess_resize": 1}
WIDE_BF16_EXPECTED = {"fused_bottleneck_general_bf16": 31, "upsample2x_add_bf16": 8,
                      "decode_heatmaps": 1, "preprocess_resize": 1}
WIDE_CONF_TOL = 2e-5    # kernels vs plain twin on the same input, float32
WIDE_MARGIN = 2e-4      # ... and the same cells above this top-2 margin
WIDE_TIES = 0.05        # at most this share of the image-joints below it (PERF.md §2's h36m rule)
WIDE_CLI_FRAMES = 3     # cli.main --checkpoint over the bundled recording's first frames
# (w) the README's toy trainer; its evals run the general instance (11 blocks
# of 16->8->16 and 8->8->16 per forward, one forward of the 105 golden images)
TOY_ARGS = ["--input", "64x128", "--features", "16", "--stacks", "1", "--depth", "2",
            "--steps", "4", "--batch-size", "8"]
TOY_BLOCKS = 11
# (u) rows beside the path's shapes: the toy trainer's eval shapes and a width
# that is no multiple of 8, at float32 and bf16
TOY_SHAPES = [(105, 32, 64, 8, 8, 16, True, False), (105, 16, 32, 16, 8, 16, False, False),
              (105, 16, 32, 20, 10, 20, False, False)]
GENERAL_QUICK_FLOPS = 4e10      # rows of more work than this are timed with fewer repeats


def block_flops(key):
    """Operations of one folded block at ``key`` = (N, H, W, Cin, Cmid, Cout,
    projection, raw): two per multiply-add of its four products."""
    n, h, w, cin, cmid, cout, proj, _ = key
    return 2.0 * n * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                              + (cin * cout if proj else 0))


def bottleneck_row(torch, np, F, dev, gen, key, f, dtype, quick=False):
    """One kernel-phase row of the bottleneck kernel (whichever instance
    ``fused_bottleneck`` launches) at ``key`` = (N, H, W, Cin, Cmid, Cout,
    projection, raw) and dtype, on a seeded input: the kernel against its
    plain version (float32: BLOCK_TOL of the output's magnitude, and against
    its 3xTF32 model; bf16: BF16_BLOCK_ULPS), its times (``quick``: fewer
    repeats) against the bound (float32: three TF32 MMAs per product, the f32
    CUDA-core bound beside; bf16 at 989 TFLOP/s and 2-byte activations) and
    one library call (cuDNN ``F.conv2d``, TF32 off at float32, native bf16).
    -> the row; raises."""
    from deepfly3d_torch.ops import bottleneck as bn

    n, h, w, cin, cmid, cout, proj, raw = key
    f32 = dtype == "float32"
    x = torch.randn((n, h, w, cin), generator=gen).to(dev).to(getattr(torch, dtype))
    y = bn.fused_bottleneck(x, f)
    ref = bn.bottleneck_plain(x, f)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if f32:
        scale = max(1.0, ref.abs().max().item())
        acc = {"model_err": (y - bn.bottleneck_tf32_model(x, f)).abs().max().item(),
               "magnitude": scale}
        if not max(err, acc["model_err"]) <= BLOCK_TOL * scale:
            raise AssertionError(f"bottleneck {key}: max abs err {err} (against its arithmetic "
                                 f"model {acc['model_err']}) > {BLOCK_TOL} x {scale}")
    else:
        share, ulps = bf16_ulps(np, y.float().cpu().numpy(), ref.float().cpu().numpy())
        acc = {"ulps": ulps, "share_differing": share,
               "magnitude": ref.float().abs().max().item()}
        if not ulps <= BF16_BLOCK_ULPS:
            raise AssertionError(f"bf16 bottleneck {key}: {ulps} ulps of the output's magnitude "
                                 f"(> {BF16_BLOCK_ULPS}), {share} of the elements differ")
    lw = {k: f[k].t().contiguous()[:, :, None, None] for k in ("w1", "w3", "wp") if k in f}
    lw["w2"] = f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1).contiguous()
    lb = {k: f[k][0].to(x.dtype) for k in ("b1", "b2", "b3", "bp") if k in f}

    def library():
        xc = x.permute(0, 3, 1, 2)                          # channels_last NCHW view
        a1 = torch.relu(xc * f["s1"].view(1, -1, 1, 1) + f["t1"].view(1, -1, 1, 1))
        a2 = torch.relu(F.conv2d(a1, lw["w1"], lb["b1"]))
        a3 = torch.relu(F.conv2d(a2, lw["w2"], lb["b2"], padding=1))
        z = F.conv2d(a3, lw["w3"], lb["b3"])
        return z + (F.conv2d(xc if raw else a1, lw["wp"], lb["bp"]) if proj else xc)

    lib_err = (library().permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
    flops = block_flops(key)
    e = 4 if f32 else 2
    nbytes = e * (n * h * w * (cin + cout) + flops / (2.0 * n * h * w)) + 4.0 * (
        2 * cin + 2 * cmid + cout + (cout if proj else 0))
    b_ms, b_by = (bound_ms(3.0 * flops, nbytes, PEAK_TF32_FLOPS) if f32
                  else bound_ms(flops, nbytes, PEAK_BF16_FLOPS))
    return {"shape": list(key[:6]), "proj": proj, "raw": raw,
            "tile": list(bn.choose_tile(*key[:7], dtype)), "max_abs_err": err,
            "library_err": lib_err, **acc,
            **times(torch, lambda: bn.fused_bottleneck(x, f), lambda: bn.bottleneck_plain(x, f),
                    library, quick=quick),
            **({"bound_f32_ms": bound_ms(flops, nbytes)[0]} if f32 else {}),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}


def wide_twin_check(torch, np, what, pipe, twin, frames, out, twin_out):
    """A float32 pipeline against its plain twin: each net against its twin's
    on the same input (the path's preprocessed frames): conf within
    WIDE_CONF_TOL, the same cells wherever the twin's top-2 margin exceeds
    WIDE_MARGIN, at most WIDE_TIES of the image-joints below it; the outputs
    (whose preprocess differs at the last bit): conf within 1e-4 (the slice
    phase's rule) and no more differing p38 entries than near-ties.  Raises."""
    p38, conf = out
    q38, qconf = twin_out
    x_u8, flip, reg, _, _ = pipe._register(frames)
    ties = 0
    for attr, net in pipe.nets().items():
        x = pipe.preprocess(x_u8, flip, pipe.input_shape, net.spec.preprocess_dtype,
                            shift=None if reg is None else reg[:2],
                            gain=None if reg is None else reg[2])
        with torch.inference_mode():
            hk = net(x)[-1].cpu().numpy()
            hp = twin.nets()[attr](x)[-1].cpu().numpy()
        (ck, confk, _), (cp, confp, mp) = decode_np(np, hk), decode_np(np, hp)
        conf_err = float(np.abs(confk - confp).max())
        decided = mp > WIDE_MARGIN
        ties += int((~decided).sum())
        n_diff = int((ck != cp).sum())
        note = (f"{attr}: conf {conf_err:.2e} (<= {WIDE_CONF_TOL}), cells differ at {n_diff} of "
                f"{ck.size}, {int((ck != cp)[decided].sum())} where the twin's top-2 margin "
                f"exceeds {WIDE_MARGIN}; {float((~decided).mean()):.4f} of the image-joints "
                f"within it (<= {WIDE_TIES})")
        print(f"{what} vs plain, same input: {note}")
        if conf_err > WIDE_CONF_TOL or (ck != cp)[decided].any() or (~decided).mean() > WIDE_TIES:
            raise AssertionError(f"{what} vs plain: {note}")
    conf_diff = float((conf - qconf).abs().max())
    n_diff = int((p38 != q38).any(-1).sum())
    if conf_diff > 1e-4 or n_diff > ties:
        raise AssertionError(f"{what} vs plain: output conf {conf_diff}, {n_diff} p38 entries "
                             f"differ (near-ties {ties})")
    print(f"{what} vs plain on the card: output conf max diff {conf_diff}, {n_diff} p38 entries "
          f"differ (near-ties {ties})")


def wide_phase(torch, np, F, dev, card, calib, order, frames, ref0, record, shape_rows, gen,
               checks, profile=None):
    """Phase 13: the converter's default 256-wide checkpoint on the card.
    -> ({path: launches}, informational lines).

    The seeded torch state dict under the sh8 names (``utils/synthetic``) is
    converted by ``convert_torch.main`` at its defaults.  (u) the kernel phase
    of the general instance at every shape the two paths below give it
    (recorded from their plain twins) and at TOY_SHAPES, float32 and bf16,
    and of the paths' other kernels at their shapes (the upsample-add at 256
    channels among them) through ``checks``, phase 4's and phase 12's;
    (t) ``build_pipeline`` of it with every count set to 0 just before and
    read just after (WIDE_EXPECTED: the general instance only), against its
    plain twin (``wide_twin_check``), frames/s and device ms per call; then
    ``PoseEstimator.infer_images`` on golden frame 0 and ``cli.main
    --checkpoint`` over the bundled recording's first WIDE_CLI_FRAMES frames,
    each counted; (v) the same spec at ``compute_dtype="bfloat16"``
    (WIDE_BF16_EXPECTED; ``bf16_twin_check``); (w) ``train_fly_weights`` at
    TOY_ARGS in a temporary folder, counted: its evals run the general
    instance and nothing else of the bottleneck."""
    import io

    from deepfly3d_torch import cli, train_fly_weights
    from deepfly3d_torch.io import result_schema
    from deepfly3d_torch.models import convert_torch
    from deepfly3d_torch.models.hourglass import HourglassSpec, load_weights
    from deepfly3d_torch.models.inference import PoseEstimator
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin
    from deepfly3d_torch.utils import synthetic

    wrappers = (bn.fused_bottleneck, kernels.upsample2x_add, kernels.decode_heatmaps,
                kernels.preprocess_resize)
    counted = tuple(counts_with_bf16(wrappers))

    def counted_run(run):
        zero_counts(wrappers)
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        return out, {k: v for k, v in counts_with_bf16(wrappers).items() if v}

    launches, lines = {}, []
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_wide_")
    try:
        arrays = synthetic.random_checkpoint(os.path.join(tmp, "seeded.npz"), WIDE_SEED, 2, 256,
                                             4, 19, (256, 512))
        tar, ckpt = os.path.join(tmp, "sh8_seeded.tar"), os.path.join(tmp, "sh8_converted.npz")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   synthetic.torch_state_dict(arrays, 2, 4).items()}}, tar)
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = convert_torch.main([tar, ckpt])
        variables, spec = load_weights(ckpt)
        want_spec = HourglassSpec(num_stacks=2, features=256, depth=4, num_blocks=1,
                                  num_classes=19, stem="conv", input_shape=(256, 512),
                                  proj_from_raw=True)
        if rc != 0 or spec != want_spec:
            raise AssertionError(f"convert_torch.main: rc {rc}, spec {spec}")
        print(f"(t) {said.getvalue().strip()}")
        pipes = {"converted256": build_pipeline(spec, variables, calib, order, rig="auto",
                                                device=dev),
                 "converted256_bf16": build_pipeline(
                     dataclasses.replace(spec, compute_dtype="bfloat16"), variables, calib, order,
                     rig="auto", device=dev)}
        rows = {}
        for path, pipe in pipes.items():
            record_shapes(plain_twin(pipe), path, rows, lambda twin: twin(frames))

        # (u) the kernel phase at the general instance's shapes
        for (kernel, key), row in sorted(rows.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            if kernel.startswith("fused_bottleneck_general"):
                dtype = "bfloat16" if kernel.endswith("_bf16") else "float32"
                f = {k: v.to(dev) for k, v in row["extra"].items()}
                record(kernel, bottleneck_row(torch, np, F, dev, gen, key, f, dtype,
                                              quick=block_flops(key) >= GENERAL_QUICK_FLOPS),
                       row["counts"])
            else:
                checks[kernel](key, row["counts"])
            torch.cuda.empty_cache()
        for key in TOY_SHAPES:
            for dtype in ("float32", "bfloat16"):
                params, stats = seeded_block(np, *key[3:6])
                if not key[6]:
                    params.pop("proj")
                f = bn.add_packed(bn.fold_bottleneck(params, stats, key[7], dtype))
                record("fused_bottleneck_general" + ("_bf16" if dtype == "bfloat16" else ""),
                       bottleneck_row(torch, np, F, dev, gen, key,
                                      {k: v.to(dev) for k, v in f.items()}, dtype), {})
        print(json.dumps({"wide_kernel_shapes": [
            r for r in shape_rows if set(r["launches_by_path"]) & set(pipes)
            or "_general" in r["kernel"]]}))

        # (t) and (v): each path once, counted, against its plain twin
        for path, pipe in pipes.items():
            bf16 = path.endswith("_bf16")
            (pts3d, p38, conf), got = counted_run(lambda: pipe(frames))
            want = WIDE_BF16_EXPECTED if bf16 else WIDE_EXPECTED
            recorded = {k: sum(row["counts"][path] for (kernel, _), row in rows.items()
                               if kernel == k) for k in counted}
            if got != want or got != {k: v for k, v in recorded.items() if v}:
                raise AssertionError(f"{path} launches {got}, want {want} (recorded {recorded})")
            launches[path] = got
            print(f"({'v' if bf16 else 't'}) {path} launches: {got}")
            if not (torch.isfinite(pts3d).all() and pts3d.shape == (BATCH_T, 38, 3)
                    and conf.shape == (p38.shape[0], BATCH_T, 19, 1)):
                raise AssertionError(f"{path} outputs have the wrong shape or are not finite")
            twin = plain_twin(pipe)
            before = counts_with_bf16(wrappers)
            _, q38, qconf = twin(frames)
            torch.cuda.synchronize()
            if counts_with_bf16(wrappers) != before:
                raise AssertionError(f"the plain {path} pipeline launched a kernel")
            if bf16:
                bf16_twin_check(torch, np, dev, f"(v) {path}", pipe, twin, frames,
                                lambda attr: variables, (p38, conf), (q38, qconf))
            else:
                wide_twin_check(torch, np, f"(t) {path}", pipe, twin, frames, (p38, conf),
                                (q38, qconf))
            pipe(frames)                                         # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                pipe(frames)
            torch.cuda.synchronize()
            fps = 3 * BATCH_T / (time.perf_counter() - t0)
            if profile is not None:
                with open(profile, "a") as fh:
                    fh.write(f"\n==== {path} path, one call at T={BATCH_T}\n")
            dms = device_ms(torch, lambda: pipe(frames), profile)
            lines.append(f"informational: {path} {fps:.1f} frames/s (T={BATCH_T}, frames on "
                         f"the card), device ms per call (torch.profiler) {dms[0]:.3f}; the "
                         f"kernels that took most (ms) {dms[1]}; on {card}")
            print(lines[-1])
            if not bf16:
                # the same checkpoint through PoseEstimator and cli.main --checkpoint
                flips0 = np.isin(np.arange(7), np.asarray(order)[4:])
                est = PoseEstimator(ckpt, device=dev)
                (pts, pconf, hm), got = counted_run(lambda: est.infer_images(
                    ref0["frames"], flips0, batch_size=7, return_heatmaps=True))
                if got != WIDE_EXPECTED or est.rig is not None:
                    raise AssertionError(f"(t) PoseEstimator launches {got}, want "
                                         f"{WIDE_EXPECTED}")
                qpts, qconf0, qhm = plain_twin(est).infer_images(ref0["frames"], flips0,
                                                                 batch_size=7,
                                                                 return_heatmaps=True)
                _, _, margin = decode_np(np, qhm)
                differ = (np.abs(pts - qpts) > CELL_ATOL).any(-1)
                conf_diff = float(np.abs(pconf - qconf0).max())
                if conf_diff > 1e-4 or differ[margin > WIDE_MARGIN].any():
                    raise AssertionError(f"(t) PoseEstimator vs plain: conf {conf_diff}, "
                                         f"{int(differ.sum())} cells differ")
                print(f"(t) PoseEstimator.infer_images on golden frame 0 (7 images): launches "
                      f"{got}; vs plain: conf max diff {conf_diff}, {int(differ.sum())} cells "
                      f"differ, none above the {WIDE_MARGIN} margin")
                rec = os.path.join(tmp, "reference")
                shutil.copytree(os.path.join(ROOT, "tests", "data", "reference"), rec)
                out = os.path.join(tmp, "out")
                args = [rec, "--checkpoint", ckpt, "-n", str(WIDE_CLI_FRAMES), "--output-folder",
                        out, "--device", str(dev)]
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    rc, got = counted_run(lambda: cli.main(args))
                batches = -(-7 * WIDE_CLI_FRAMES // 8)
                want = {k: v * batches for k, v in WIDE_EXPECTED.items()}
                saved = result_schema.load_result(result_schema.result_path(out, rec))
                if rc != 0 or got != want or saved["points2d"].shape != (7, WIDE_CLI_FRAMES, 38, 2) \
                        or not np.isfinite(saved["points3d"]).all():
                    raise AssertionError(f"(t) cli.main --checkpoint: rc {rc}, launches {got} "
                                         f"(want {want})")
                launches["converted256_cli"] = got
                print(f"(t) cli.main --checkpoint (the converted file) -n {WIDE_CLI_FRAMES}: "
                      f"launches {got}, a finite result; "
                      + printed.getvalue().strip().splitlines()[-1])

        # (w) the README's toy trainer: its evals run the general instance
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, got = counted_run(lambda: train_fly_weights.main(
                TOY_ARGS + ["--out", os.path.join(tmp, "tiny.npz"), "--device", str(dev)]))
        evals = got.get("decode_heatmaps", 0)
        want = {"fused_bottleneck_general": TOY_BLOCKS * evals, "upsample2x_add": 2 * evals,
                "decode_heatmaps": evals, "preprocess_resize": evals + 1}
        if rc not in (0, 1) or evals < 1 or got != want \
                or not os.path.exists(os.path.join(tmp, "tiny.npz")):
            raise AssertionError(f"(w) train_fly_weights {' '.join(TOY_ARGS)}: rc {rc}, "
                                 f"launches {got} (want {want})")
        launches["train_toy"] = got
        print(f"(w) python -m deepfly3d_torch.train_fly_weights {' '.join(TOY_ARGS)}: exit {rc} "
              f"in {time.perf_counter() - t0:.1f} s, launches {got}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, lines


# phases 14-16: the last three modules.  14, bf16 training: the committed
# JAX bf16 trajectory of (l)'s 5 steps (PYTHONPATH=. python
# tests/test_torch_train_bf16.py --write), each step's [loss, mse, peak_err]
# within BF16_K5_FRAC of JAX's own bf16-vs-float32 gap of that step (plus
# 1e-6 of its size), every parameter within 2 lr per step of JAX's; the
# script at bf16 (--steps as (m) cuts the recipe's 16,000); the
# data-parallel bf16 step on this card against the one-device step, losses
# within BF16_DP_FRAC of the one-device step's bf16-vs-float32 gap.  Two
# bf16 implementations of one graph lie about as far apart as bf16 from
# float32 (cuDNN's sums against XLA's round other elements, as the bf16
# serving path's rule allows for): the first step, at the checkpoint's weights, measured
# 1.25x on the card (NVIDIA H100 80GB HBM3, 700 W), the later ones <= 0.91x.
BF16_TRAIN_REF = os.path.join("deepfly3d_torch", "data", "train_fly_bf16_k5.npz")
BF16_K5_FRAC = 2.0
BF16_DP_FRAC = 2.0
BF16_SCRIPT_ARGS = ["--resume", "--dtype", "bfloat16", "--steps", "100", "--batch-size",
                    str(TRAIN_BATCH)]
# 15, the harness (deepfly3d_torch/bench.py): the JAX
# package's contract and probe errors on the conv checkpoint (python
# tests/test_torch_bench.py --write), held to PERF.md §2's parity rule
PROBES_REF = os.path.join("deepfly3d_torch", "data", "bench_probes_conv.json")
PROBE_PTS_TOL, PROBE_CONF_TOL = 1e-6, 2e-5
PROBE_NAMES = ("reencode", "jpeg_q90", "shift-2px", "shift+2px", "gain0.95", "gain1.05")
HARNESS_T = 8
# 16, the calibration (deepfly3d_torch/calibrate_score_head.py) of the conv
# checkpoint at bf16: every device part at full width, the host fit cut to
# these joints of the last score head (fit_scores' own input: the columns of
# those joints; ~140 s of host time per joint on the card's machine)
CAL_JOINTS = (0,)


def bf16_train_phase(torch, np, dev, card, counters, f32_lines):
    """Phase 14 on the card.  -> ({path: launches}, informational lines)."""
    import io

    from deepfly3d_torch import train_fly_weights
    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.models import train as train_mod
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.parallel import mesh as mesh_mod
    from deepfly3d_torch.parallel import pipeline as par

    launches, lines = {}, []
    variables, spec = hg.load_weights(os.path.join(WEIGHTS_DIR, CONV))
    bf16 = dataclasses.replace(spec, compute_dtype="bfloat16")

    # the 5-step trajectory against JAX's bf16 one
    with np.load(os.path.join(ROOT, BF16_TRAIN_REF)) as z:
        ref = {k: z[k] for k in z.files}
    frames, flips, targets, cells, peaks = k5_batch(np)
    x = image_ops.preprocess_frames(torch.from_numpy(frames).to(dev),
                                    torch.from_numpy(flips).to(dev), (256, 512))
    net = hg.trainable(variables, bf16, device=dev)
    tx = train_mod.adam(K5_LR)
    opt_state = tx(net.parameters())
    epoch = train_mod.make_train_epoch(bf16, tx, 100.0, 1, len(frames), freeze_bn=True)
    rng = torch.Generator(device=dev).manual_seed(0)
    losses = np.asarray([epoch(net, opt_state, rng, x, torch.from_numpy(targets).to(dev),
                               torch.from_numpy(cells).long().to(dev),
                               torch.from_numpy(peaks).to(dev)) for _ in range(5)])
    out = hg.module_variables(net)
    want, other = ref["bfloat16/losses"], ref["float32/losses"]
    gap = np.abs(want - other)
    ratio = np.abs(losses - want) / np.maximum(gap, 1e-30)
    bad = [f"losses {losses.tolist()} against JAX bf16 {want.tolist()} (float32 "
           f"{other.tolist()})"] if not (np.abs(losses - want)
                                         <= BF16_K5_FRAC * gap + 1e-6 * np.abs(want)).all() else []
    leaf_diff = {}
    for k in K5_LEAVES:
        d = float(np.abs(_leaf(np, out, k) - ref[f"bfloat16/{k}"]).max())
        leaf_diff[k] = d
        if d > 2 * K5_LR * 5 + 1e-6:
            bad.append(f"{k}: {d} beyond 2 lr per step")
    if bad:
        raise AssertionError(f"(w) bf16 5-step trajectory off JAX's: {bad}")
    print(f"(w) bf16: 5 frozen-statistics steps of the conv checkpoint at bf16 on "
          f"{len(K5_CAMERAS)} golden images: losses {losses[:, 0].tolist()} against JAX bf16 "
          f"{want[:, 0].tolist()} (float32 {other[:, 0].tolist()}); |port - JAX bf16| / "
          f"|JAX bf16 - JAX float32| per step and term, largest {float(ratio.max()):.3f} "
          f"(<= {BF16_K5_FRAC}); parameters max diff {max(leaf_diff.values()):.3g} "
          f"(<= 2 lr per step)")
    del net, opt_state

    # device time and peak memory of one Adam step at the script's batch,
    # float32 and bf16 in turns
    step_ms, step_top, step_wall, step_mem = {}, {}, {}, {}
    for name, s in (("float32", spec), ("bfloat16", bf16)):
        call = train_step_call(torch, np, dev, s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        call()
        torch.cuda.synchronize()
        step_mem[name] = torch.cuda.max_memory_allocated(dev) / 2**30
        timed = [device_ms(torch, call) for _ in range(2)]
        step_ms[name], step_top[name] = [t[0] for t in timed], timed[0][1]
        step_wall[name] = cuda_ms(torch, call, iters=10, warmup=1)
        del call
    lines.append(f"(w) one BN-training Adam step at batch {TRAIN_BATCH}, device time "
                 f"(torch.profiler, two turns): float32 {step_ms['float32']} ms, bf16 "
                 f"{step_ms['bfloat16']} ms; per step over 10 eager steps (CUDA events, the "
                 f"host's launches included): float32 {step_wall['float32']:.2f} ms, bf16 "
                 f"{step_wall['bfloat16']:.2f} ms; peak memory float32 "
                 f"{step_mem['float32']:.2f} GiB, bf16 {step_mem['bfloat16']:.2f} GiB; the "
                 f"kernels that took most (ms) {json.dumps(step_top)}")
    print("informational: " + lines[-1] + f", on {card}")

    # the training script at bf16, resumed from the conv checkpoint in a
    # temporary folder; its evals run the unfolded bf16 network between the
    # preprocess and decode kernels
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_train_bf16_")
    try:
        path = os.path.join(tmp, CONV)
        shutil.copy(os.path.join(WEIGHTS_DIR, CONV), path)
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, got = count_launches(torch, counters, lambda: train_fly_weights.main(
                BF16_SCRIPT_ARGS + ["--out", path]))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        text = buf.getvalue()
        print("\n".join("  train_fly_weights: " + line for line in text.splitlines()
                        if not line.startswith("{'step'")))
        # the inputs and two evals (step 100 and the final one) through the
        # preprocess kernel, each eval's heatmaps through the decode kernel
        want_l = {"fused_bottleneck": 0, "upsample2x_add": 0, "decode_heatmaps": 2,
                  "preprocess_resize": 3}
        if got != want_l or rc not in (0, 1) or not os.path.exists(path):
            raise AssertionError(f"(w) train_fly_weights --dtype bfloat16: rc {rc}, launches "
                                 f"{got} (want {want_l})")
        launches["train_script_bf16"] = got
        seconds = float(text.split("training took ")[1].split("s")[0])
        final = text.split("final (after BN recalibration): ")[1].splitlines()[0]
        steps = int(BF16_SCRIPT_ARGS[BF16_SCRIPT_ARGS.index("--steps") + 1])
        hg.load_weights(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines.append(f"(w) python -m deepfly3d_torch.train_fly_weights {' '.join(BF16_SCRIPT_ARGS)}: "
                 f"exit {rc}, {steps / seconds:.2f} steps/s, "
                 f"{steps * TRAIN_BATCH / seconds:.1f} images/s ({seconds:.1f} s of training "
                 f"with one eval, {wall:.1f} s in all), peak memory {peak / 2**30:.2f} GiB, "
                 f"golden {final}; launches {got}; beside float32: "
                 + "; ".join(f32_lines))
    print("informational: " + lines[-1] + f", on {card}")

    # the data-parallel bf16 step on this card (1 and 2 entries) against the
    # one-device step, Adam eps 10 as (n)
    rs = np.random.default_rng(0)
    xs = rs.uniform(size=(SHARDED_BATCH, 256, 512, 3)).astype(np.float32)
    ts = rs.uniform(size=(SHARDED_BATCH, 64, 128, 19)).astype(np.float32)
    init = hg.init_params(spec, (256, 512), torch.Generator(device=dev).manual_seed(0), dev)

    def sharded(s, entries):
        init_fn, step_fn = par.make_sharded_train_step(s, mesh_mod.data_mesh(
            devices=[dev] * entries))
        params, stats, opt = init_fn(0, (256, 512))
        with torch.no_grad():
            _copy_tree(params, init["params"])
            _copy_tree(stats, init["batch_stats"])
        for group in opt.param_groups:
            group["eps"] = 10.0
        out_l = []
        for _ in range(2):
            params, stats, opt, loss = step_fn(params, stats, opt, xs, ts)
            out_l.append(loss.item())
        return out_l, params

    def one_device(s):
        n = hg.trainable(init, s, dev)
        opt = train_mod.adam(1e-3, eps=10.0)(n.parameters())
        xd, td = torch.from_numpy(xs).to(dev), torch.from_numpy(ts).to(dev)
        out_l = []
        for _ in range(2):
            loss = ((n(xd, train=True) - td[None]) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            out_l.append(loss.item())
        return out_l, hg.module_variables(n)["params"]

    t0 = time.perf_counter()
    base_losses, base_params = one_device(bf16)
    f32_losses = one_device(spec)[0]
    gap_l = np.abs(np.asarray(base_losses) - np.asarray(f32_losses))
    diffs = {}
    for name, entries in (("1 entry", 1), ("2 entries on one card", 2)):
        losses_n, params_n = sharded(bf16, entries)
        a = {k: v.detach().cpu().numpy() for k, v in _flat(params_n).items()}
        b = _flat(base_params)
        d = max(float(np.abs(a[k] - b[k]).max()) for k in b)
        err = np.abs(np.asarray(losses_n) - np.asarray(base_losses))
        diffs[name] = (float((err / np.maximum(gap_l, 1e-30)).max()), d)
        if (err > BF16_DP_FRAC * gap_l + 1e-6 * np.abs(base_losses)).any() or d > 2 * 1e-3 * 2:
            raise AssertionError(f"(w) bf16 {name}: losses {losses_n} against the one-device "
                                 f"step's {base_losses} (float32 {f32_losses}), parameters {d}")
    print(f"(w) bf16 make_sharded_train_step at full width, batch {SHARDED_BATCH}, 2 steps: "
          f"one-device losses {base_losses} (float32 {f32_losses}); against it (losses as a "
          f"share of the bf16-vs-float32 gap, <= {BF16_DP_FRAC}; parameters abs): "
          f"{json.dumps(diffs)}; {time.perf_counter() - t0:.1f} s")
    return launches, lines


def harness_phase(torch, np, dev, card, counters, paths):
    """Phase 15 on the card: ``paths`` are the conv, p16 and cascade
    pipelines (rig on).  -> ({path: launches}, informational lines)."""
    from deepfly3d_torch import bench

    launches, lines = {}, []
    with open(os.path.join(ROOT, PROBES_REF)) as fh:
        ref = json.load(fh)
    frames, golden = bench.load_golden_frames()
    conv = paths["conv"]
    (pts_err, conf_err, ok), got = count_launches(
        torch, counters, lambda: bench.verify_contract(conv, frames, golden))
    if got != EXPECTED["conv"]:
        raise AssertionError(f"(x) verify_contract launches {got}, want {EXPECTED['conv']}")
    launches["harness_contract"] = got
    jref = ref["golden"]
    if not (ok and abs(pts_err - jref["pts_err"]) <= PROBE_PTS_TOL
            and abs(conf_err - jref["conf_err"]) <= PROBE_CONF_TOL):
        raise AssertionError(f"(x) verify_contract, conv: pts_err {pts_err}, conf_err "
                             f"{conf_err}, pass {ok}; JAX {jref}")
    print(f"(x) bench.verify_contract, conv checkpoint, 15 frames x 7 cameras, rig on: pts_err "
          f"{pts_err} conf_err {conf_err} PASS (JAX: {jref['pts_err']}, {jref['conf_err']}); "
          f"launches {got}")

    t0 = time.perf_counter()
    probes = bench.load_probe_frames()
    t_load = time.perf_counter() - t0
    if tuple(probes) != PROBE_NAMES:
        raise AssertionError(f"(x) probes {list(probes)}, want all six {PROBE_NAMES}")
    rows, bad = {}, []
    for name, (pf, pts_tol, conf_tol) in probes.items():
        want = ref["probes"][name]
        digest = hashlib.sha256(np.ascontiguousarray(pf).tobytes()).hexdigest()
        (p_err, c_err, _), got = count_launches(
            torch, counters, lambda pf=pf: bench.verify_contract(conv, pf, golden))
        launches[f"harness_probe_{name}"] = got
        rows[name] = {"pts_err": p_err, "conf_err": c_err, "jax_pts_err": want["pts_err"],
                      "jax_conf_err": want["conf_err"], "frames_as_jax": digest == want["sha256"]}
        if (digest != want["sha256"] or abs(p_err - want["pts_err"]) > PROBE_PTS_TOL
                or abs(c_err - want["conf_err"]) > PROBE_CONF_TOL or got != EXPECTED["conv"]
                or (pts_tol, conf_tol) != (want["pts_tol"], want["conf_tol"])):
            bad.append(name)
    report, all_pass = bench.verify_probes(conv, probes, golden)
    print(f"(x) bench.load_probe_frames: all six probes ({t_load:.1f} s); each through "
          f"verify_contract against JAX's committed report (points within {PROBE_PTS_TOL}, "
          f"conf within {PROBE_CONF_TOL}): {json.dumps(rows)}; verify_probes "
          f"{'PASS' if all_pass else 'FAIL'}: {json.dumps(report)}")
    if bad:
        raise AssertionError(f"(x) probes off JAX's committed report: {bad}")

    # frames/s and the FLOP share, informational
    fps_rows = {}
    for path in ("conv", "p16", "cascade"):
        pipe = paths[path]
        (fps, x, iters, dt), got = count_launches(
            torch, counters, lambda pipe=pipe: bench.measure_fps(pipe, HARNESS_T))
        calls = iters + 1
        want_l = {k: v * calls for k, v in EXPECTED[path].items()}
        if got != want_l:
            raise AssertionError(f"(x) measure_fps {path}: launches {got}, want {want_l}")
        launches[f"harness_fps_{path}"] = got
        mfu = bench.pipeline_mfu(pipe, x, iters, dt)
        fps_rows[path] = {"frames_per_s": fps, "iters": iters, "seconds": dt, **mfu}
        del x
    t0 = time.perf_counter()
    ba = bench.bench_bundle_adjust()
    lines.append(f"(x) bench.measure_fps at T={HARNESS_T} and pipeline_mfu: "
                 f"{json.dumps(fps_rows)}; bench_bundle_adjust (median, IQR ms, host): "
                 f"{json.dumps(ba)} ({time.perf_counter() - t0:.1f} s)")
    print("informational: " + lines[-1] + f", on {card}")
    return launches, lines


def calibration_phase(torch, np, dev, card, counters):
    """Phase 16 on the card.  -> ({path: launches}, informational lines)."""
    from deepfly3d_torch import bench
    from deepfly3d_torch import calibrate_score_head as cal
    from deepfly3d_torch.config import WEIGHTS_DIR, fly_config
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline

    launches, lines, secs = {}, [], {}
    variables, spec0 = hg.load_weights(os.path.join(WEIGHTS_DIR, CONV))
    spec0 = dataclasses.replace(spec0, compute_dtype="bfloat16", hp_scope="score",
                                preprocess_dtype="float32")
    variables, spec = cal.embed_score_3x3(variables, spec0)
    shape = tuple(spec.input_shape or (256, 512))

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    (feat, heat, golden, sets), got = count_launches(torch, counters, lambda: timed(
        "extract_features_s", lambda: cal.extract_features(variables, spec, shape, device=dev)))
    want_l = {"fused_bottleneck": 0, "upsample2x_add": 0, "decode_heatmaps": 0,
              "preprocess_resize": 1}
    if got != want_l or tuple(feat.shape) != (105, 64, 128, spec.features) \
            or not torch.isfinite(feat).all() or not np.isfinite(heat).all():
        raise AssertionError(f"(y) extract_features: launches {got} (want {want_l}), feat "
                             f"{tuple(feat.shape)}")
    launches["calibrate_extract"] = got
    gram = timed("compute_gram_s", lambda: cal.compute_gram(feat))
    check = cal.make_device_check(feat, spec.head_upsample)
    S_ = spec.num_stacks
    kernel = np.asarray(variables["params"][f"score{S_ - 1}"]["kernel"], np.float64)
    bias = np.asarray(variables["params"][f"score{S_ - 1}"]["bias"], np.float64)
    h0 = timed("device_check_s", lambda: check(kernel[..., :1], bias[:1]))
    # the check reproduces the forward's last score conv on the captured features
    flat = heat.reshape(105, -1, heat.shape[-1])
    check_err = float(np.abs(h0.reshape(105, -1) - flat[..., 0]).max())
    if not np.isfinite(gram).all() or check_err > 1e-3 * float(np.abs(flat[..., 0]).max()):
        raise AssertionError(f"(y) compute_gram finite {np.isfinite(gram).all()}, device check "
                             f"vs the forward's heatmaps {check_err}")
    targets = np.asarray(golden["heatmap_confidence"], np.float64).reshape(105, -1)
    gcells = cal.golden_cells(golden, heat.shape[1], heat.shape[2])
    cols = list(CAL_JOINTS)
    w, b, linf = timed("fit_scores_s", lambda: cal.fit_scores(
        check, feat.cpu().numpy(), gram, kernel[..., cols], bias[cols], targets[:, cols],
        gcells[:, cols], spec.head_upsample))
    kernel[..., cols], bias[cols] = w, b
    params = dict(variables["params"])
    params[f"score{S_ - 1}"] = dict(params[f"score{S_ - 1}"], kernel=kernel.astype(np.float32),
                                    bias=bias.astype(np.float32))
    cfg = fly_config()
    with open(cfg.calib_prior_path, "rb") as fh:
        calib = geometry.calib_to_arrays(pickle.load(fh), cfg.num_cameras, dtype=np.float32)
    pipe = build_pipeline(spec, dict(variables, params=params), calib,
                          golden["camera_ordering"], shape, device=dev)
    frames = torch.from_numpy(np.stack(sets[0].reshape(7, 15, 480, 960, 3), 1).copy()).to(dev)
    (pts_err, conf_err, ok), got = count_launches(torch, counters, lambda: timed(
        "deployed_contract_s", lambda: bench.verify_contract(pipe, frames, golden)))
    want_l = BF16_EXPECTED["conv_bf16"]
    if {k: v for k, v in got.items() if v} != want_l:
        raise AssertionError(f"(y) the deployed check's launches {got}, want {want_l}")
    launches["calibrate_deploy"] = got
    lines.append(f"(y) calibrate_score_head on {CONV} at bf16 (hp_scope score, 3x3 head): "
                 f"extract_features of 105 golden images, compute_gram "
                 f"({gram.shape[0]}x{gram.shape[1]}), one device check, fit_scores cut to "
                 f"joints {cols} of {heat.shape[-1]} (cached-feature L_inf {linf:.6f}), the "
                 f"deployed verify_contract: pts_err {pts_err} conf_err {conf_err} "
                 f"({'PASS' if ok else 'fail'}: the other joints keep the uncalibrated head); "
                 f"seconds {json.dumps(secs)}; launches {launches}")
    print("informational: " + lines[-1] + f", on {card}")
    return launches, lines


GUI_VIEW_WH = (480, 240)   # (z) each camera view's widget size: half the 960x480 frame
GUI_SAME_ATOL = 1e-6       # (z) the click against (c): the same kernels on the same inputs


def gui_phase(torch, np, dev, card, counters, pictorial_launches, pictorial_p2):
    """Phase 17 on the card, log lines ``(z)``: ``deepfly3d_torch/gui.py``'s
    ``DeepflyGUI`` under the headless Qt stand-in of
    ``tests/torch_qt_standin.py`` (PyQt5 is not needed), set up with
    ``device="cuda"`` on a copy of the bundled recording, frames 0-1, seeded
    with golden 2D and calibration as (c) seeds ``Core.solve_pictorial``.
    A scripted session: Pose, Correction, a drag on camera 1's view, Save
    (the pickle must resume in the port's ``Core``), Auto-correct (counted:
    (c)'s launches; its points2d within ``GUI_SAME_ATOL`` of (c)'s).
    -> ({"gui": launches}, informational lines)."""
    import importlib.util

    from deepfly3d_torch.core import Core
    from deepfly3d_torch.io import result_schema

    try:
        import PyQt5.QtWidgets  # noqa: F401
        pyqt = "imports"
    except ImportError as exc:
        pyqt = f"does not import ({exc})"
    print(f"(z) PyQt5 on this machine: {pyqt}; the session runs the real DeepflyGUI under "
          f"the headless stand-in tests/torch_qt_standin.py")
    sspec = importlib.util.spec_from_file_location(
        "_df3d_qt_standin", os.path.join(ROOT, "tests", "torch_qt_standin.py"))
    standin = importlib.util.module_from_spec(sspec)
    sspec.loader.exec_module(standin)
    golden_dir = os.path.join(ROOT, "tests", "data", "reference_df3d")
    with open(os.path.join(golden_dir, "df3d_result_2d.pkl"), "rb") as fh:
        golden_2d = pickle.load(fh)
    with open(os.path.join(golden_dir, "df3d_result_3d.pkl"), "rb") as fh:
        golden_3d = pickle.load(fh)
    qt = standin.make()
    tmp = tempfile.mkdtemp(prefix="df3d_smoke_gui_")
    try:
        with standin.installed(qt):
            gui = standin.load_gui(os.path.join(ROOT, "deepfly3d_torch", "gui.py"),
                                   "_df3d_gui_under_standin")
            # a path whose camera ordering Core knows (0-6, (c)'s order)
            rec = os.path.join(tmp, "sample", "test")
            shutil.copytree(os.path.join(ROOT, "tests", "data", "reference"), rec)
            window = gui.DeepflyGUI()
            window.setup(rec, 2, device=dev.type)
            window.core.points2d = np.array(golden_2d["points2d"][:, :2])
            window.core.conf = np.array(golden_2d["heatmap_confidence"][:, :2])
            window.core.calib = result_schema.extract_calib(golden_3d)
            for iv in window.image_views:
                iv.resize(*GUI_VIEW_WH)
            QEvent = qt.modules["PyQt5.QtCore"].QEvent

            standin.button(window, "Pose").click()
            standin.button(window, "Correction").click()
            if [b.isChecked() for b in (window.button_image_mode, window.button_pose_mode,
                                        window.button_correction_mode)] != [False, False, True]:
                raise AssertionError("(z) the Correction button is not the one checked")
            view = window.image_views[1]
            x, y = window.core.corrected_points2d(1, 0)[2]
            sx, sy = GUI_VIEW_WH[0] / 960.0, GUI_VIEW_WH[1] / 480.0
            took = [standin.send_event(view, standin.MouseEvent(kind, px, py)) for kind, px, py in (
                (QEvent.MouseButtonPress, x * sx, y * sy),
                (QEvent.MouseMove, x * sx + 60.0, y * sy + 30.0),
                (QEvent.MouseButtonRelease, 0.0, 0.0))]
            dragged = window.core.db.read(1, 0)
            if took != [True, True, True] or dragged is None:
                raise AssertionError(f"(z) the drag on camera 1: filter took {took}, "
                                     f"correction stored {dragged is not None}")
            standin.button(window, "Save").click()
            resumed = Core(rec, None, 2, None, device=dev)
            if not (np.array_equal(resumed.points2d, window.core.points2d)
                    and resumed.has_calibration
                    and np.array_equal(resumed.db.read(1, 0), dragged)):
                raise AssertionError("(z) the saved session does not resume in the port's Core")

            t0 = time.perf_counter()
            _, got = count_launches(torch, counters,
                                    lambda: standin.button(window, "Auto-correct").click())
            click_s = time.perf_counter() - t0
            if got != pictorial_launches or not all(got.get(k) for k in EXPECTED["conv"]):
                raise AssertionError(f"(z) Auto-correct launches {got}, want (c)'s "
                                     f"{pictorial_launches}")
            p2 = window.core.points2d
            diff = float(np.abs(p2 - pictorial_p2).max())
            if not (p2.shape == pictorial_p2.shape and np.isfinite(p2).all()
                    and diff <= GUI_SAME_ATOL):
                raise AssertionError(f"(z) Auto-correct points2d vs (c)'s solve_pictorial: "
                                     f"max diff {diff} (<= {GUI_SAME_ATOL})")
            shown = [(iv.pixmap().image.width(), iv.pixmap().image.height())
                     for iv in window.image_views]
            if shown != [(960, 480)] * 6 or qt.warnings:
                raise AssertionError(f"(z) after Auto-correct: views {shown}, warnings "
                                     f"{[t for _, _, t in qt.warnings]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = (f"(z) the df3d GUI on {card}: Pose, Correction, a drag on camera 1 (stored, saved, "
            f"resumed in Core), then the Auto-correct click on frames 0-1: {click_s:.3f} s "
            f"(estimator build, the network on 14 images, the MAP on the host), launches "
            f"{got} (= (c)'s); corrected points2d vs (c)'s Core.solve_pictorial: max diff "
            f"{diff} ({'bit-equal' if diff == 0.0 else 'not bit-equal'}; <= {GUI_SAME_ATOL})")
    print(line)
    return {"gui": got}, [line]


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
    from deepfly3d_torch.models.inference import PoseEstimator, infer_batch
    from deepfly3d_torch.ops import _build, canonicalize, geometry, image as image_ops
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.parallel import mesh as mesh_mod
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
    # the training phase's converted path (o): the conv checkpoint read as a
    # checkpoint converted from torch (proj_from_raw), T=8, rig off
    conv_vars, conv_spec = ckpt[CONV]
    converted = types.SimpleNamespace(frames=frames, pipe=build_pipeline(
        dataclasses.replace(conv_spec, proj_from_raw=True), conv_vars, calib, order, rig=None,
        device=dev))
    record_shapes(plain_twin(converted.pipe), "converted", rows, lambda twin: twin(frames))
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
    # the fleet path (fleet phase): one forward per mesh entry over every image of
    # the recordings, on every visible card ("fleet") and on two entries of this
    # card ("fleet2"), padded with the first images as process_recordings pads
    fleet_images, fleet_flips = fleet_inputs(np)
    for key, entries in (("fleet", mesh_mod.data_mesh().size), ("fleet2", 2)):
        pad = (-len(fleet_images)) % entries
        per = (len(fleet_images) + pad) // entries

        def forwards(twin, entries=entries, pad=pad, per=per):
            x = torch.from_numpy(np.concatenate([fleet_images, fleet_images[:pad]]))
            f = torch.from_numpy(np.concatenate([fleet_flips, fleet_flips[:pad]]))
            for e in range(entries):
                infer_batch(twin.net, x[e * per:(e + 1) * per].to(dev),
                            f[e * per:(e + 1) * per].to(dev), twin.input_shape,
                            preprocess=twin.preprocess, decode=twin.decode)

        record_shapes(plain_twin(estimator), key, rows, forwards)
    del fleet_images, fleet_flips
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

    def check_bottleneck(key, counts, f):
        name = "fused_bottleneck_128" if bn.streams_w2(*key[3:7]) else "fused_bottleneck"
        record(name, bottleneck_row(torch, np, F, dev, gen, key, f, "float32",
                                    quick=key[0] >= FLEET_QUICK_N), counts)

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
                    lambda: kernels.upsample2x_add_plain(inner, skip), library,
                    quick=n >= FLEET_QUICK_N),
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
                    lambda: torch.max(hm_flat, dim=1), quick=n >= FLEET_QUICK_N),
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
               "taps": [kh, kw], "instance": kernels.preprocess_instance_for(x, out),
               "max_abs_err": err, "tolerance": tol, "library_err": lib_err,
               **times(torch, kernel, lambda: plain(**reg), library, quick=n >= FLEET_QUICK_N),
               "unfused_ms": graph_ms(torch, unfused, **({"iters": 3, "replays": 2}
                                                         if n >= FLEET_QUICK_N else {})),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
        record("preprocess_resize", row, counts)

    checks = {"fused_bottleneck": check_bottleneck, "fused_bottleneck_128": check_bottleneck,
              "upsample2x_add": check_merge,
              "decode_heatmaps": check_decode, "preprocess_resize": check_preprocess}
    for (kernel, key), row in sorted(rows.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        if kernel in ("fused_bottleneck", "fused_bottleneck_128"):
            check_bottleneck(key, row["counts"], row["extra"])
        else:
            checks[kernel](key, row["counts"])
        torch.cuda.empty_cache()
    # identity mode: exactly the TPU kernel (u8 * 1/255, flip); on no path
    check_preprocess((N,) + tuple(cfg.image_hw) + (3,) + tuple(cfg.image_hw), {})
    # (o) the raw-input projection at the h36m width (the h36m checkpoint's
    # stem_res1 read as converted, at its 192x192 after the stem) and the
    # 64-wide instance (seeded weights), a batch of 8 each; on no path
    h36m_vars, _ = load_weights(h36m_ckpt)
    check_bottleneck((8, 192, 192, 64, 64, 128, True, True), {}, raw_block(
        np, torch, dev, h36m_vars["params"]["stem_res1"], h36m_vars["batch_stats"]["stem_res1"]))
    check_bottleneck((8, 128, 256, 32, 32, 64, True, True), {}, raw_block(
        np, torch, dev, *seeded_block(np, 32, 32, 64)))
    # K x cells no multiple of 4: the decode kernel's scalar loads; on no path
    check_decode((N, 63, 127, 19), {})
    print(json.dumps({"kernel_shapes": shape_rows}))
    print(json.dumps({"per_path": per_path}))
    h36m_batches = -(-h36m_frames.shape[0] * h36m_frames.shape[1] // H36M_BATCH)
    h36m_pre = [r for r in shape_rows if r["kernel"] == "preprocess_resize"
                and r["launches_by_path"].get("h36m")]
    print(f"informational: the h36m path per batch of {H36M_BATCH} images (kernel-phase times "
          f"of its shapes times their launches, over {h36m_batches} batches), on {card}: "
          f"preprocess {per_path['h36m']['preprocess_resize']['ms'] / h36m_batches:.4f} ms per "
          f"batch ({', '.join(sorted({r['instance'] for r in h36m_pre}))}); "
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
        recorded = recorded_launches(rows, path)
        if got != EXPECTED[path] or nonzero(got) != recorded:
            raise AssertionError(f"{path} path launches {got}, want {EXPECTED[path]} "
                                 f"(recorded {recorded})")
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
            calls["train"] = train_step_call(torch, np, dev)
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
                        "train": f"one training step of the conv checkpoint at batch {TRAIN_BATCH}",
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
    core_launches, pictorial_p2 = core_phase(np, torch, dev, card, probe, counters)
    launches.update(core_launches)

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

    # ---- 10. fleet phase: (g)-(j)
    t0 = time.perf_counter()
    fleet_launches, fleet_lines = fleet_phase(torch, np, dev, card, counters, rows)
    launches.update(fleet_launches)
    print(f"informational: the fleet path ({FLEET_COPIES} x {FLEET_T} 7-camera frames, lm "
          f"calibration per recording): {'; '.join(fleet_lines)}; the phase took "
          f"{time.perf_counter() - t0:.1f} s; per fleet call on the "
          f"{mesh_mod.data_mesh().size}-entry mesh (kernel-phase times of its shapes times "
          f"their launches): " + json.dumps({kernel: {key: row[key] for key in
                                               ("launches", "ms", "bound_ms", "plain_ms",
                                                "library_ms")}
                                             for kernel, row in per_path["fleet"].items()})
          + f"; on {card}")

    # ---- 11. training phase: (k)-(o)
    t0 = time.perf_counter()
    train_launches, train_lines = train_phase(torch, np, dev, card, counters, converted)
    launches.update(train_launches)
    print(f"informational: the training phase took {time.perf_counter() - t0:.1f} s")

    # ---- 12. bf16 phase: (p)-(s)
    t0 = time.perf_counter()
    bf16_launches, bf16_lines, bf16_checks = bf16_phase(
        torch, np, F, dev, card, ckpt, calib, order, frames, ref0, rows, checks, record,
        shape_rows, gen, argv[argv.index("--profile") + 1] if "--profile" in argv else None)
    launches.update(bf16_launches)
    print(f"informational: the bf16 phase took {time.perf_counter() - t0:.1f} s; per bf16 path "
          f"(kernel-phase times of its shapes times their launches): " + json.dumps(
              {path: {kernel: {key: row[key] for key in ("launches", "ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                      for kernel, row in per_path[path].items()} for path in BF16_PATHS})
          + f"; on {card}")

    # ---- 13. wide phase: (t)-(w), the converter's 256-wide checkpoint
    t0 = time.perf_counter()
    wide_launches, wide_lines = wide_phase(
        torch, np, F, dev, card, calib, order, frames, ref0, record, shape_rows, gen,
        {**checks, **bf16_checks}, argv[argv.index("--profile") + 1] if "--profile" in argv
        else None)
    launches.update(wide_launches)
    print(f"informational: the wide phase took {time.perf_counter() - t0:.1f} s; per wide path "
          f"(kernel-phase times of its shapes times their launches): " + json.dumps(
              {path: {kernel: {key: row[key] for key in ("launches", "ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                      for kernel, row in per_path[path].items()}
               for path in ("converted256", "converted256_bf16")}) + f"; on {card}")

    # ---- 14. bf16 training phase (w)
    t0 = time.perf_counter()
    bt_launches, _ = bf16_train_phase(torch, np, dev, card, counters, train_lines)
    launches.update(bt_launches)
    print(f"informational: the bf16 training phase took {time.perf_counter() - t0:.1f} s")

    # ---- 15. harness phase (x): deepfly3d_torch/bench.py
    t0 = time.perf_counter()
    h_launches, _ = harness_phase(torch, np, dev, card, counters, paths)
    launches.update(h_launches)
    print(f"informational: the harness phase took {time.perf_counter() - t0:.1f} s")

    # ---- 16. calibration phase (y): deepfly3d_torch/calibrate_score_head.py
    t0 = time.perf_counter()
    c_launches, _ = calibration_phase(torch, np, dev, card, counters)
    launches.update(c_launches)
    print(f"informational: the calibration phase took {time.perf_counter() - t0:.1f} s")

    # ---- 17. GUI phase (z): deepfly3d_torch/gui.py, driven through its Auto-correct button
    t0 = time.perf_counter()
    g_launches, _ = gui_phase(torch, np, dev, card, counters, launches["pictorial"],
                              pictorial_p2)
    launches.update(g_launches)
    print(f"informational: the GUI phase took {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, (src, replaces, also) in SOURCES.items():
        agg = per_kernel[name]
        if name in ("fused_bottleneck", "fused_bottleneck_128", "fused_bottleneck_general"):
            _, b_by = bound_ms(3.0 * agg["flops"], agg["bytes"], PEAK_TF32_FLOPS)
        elif name in ("fused_bottleneck_bf16", "fused_bottleneck_general_bf16"):
            _, b_by = bound_ms(agg["flops"], agg["bytes"], PEAK_BF16_FLOPS)
        else:
            _, b_by = bound_ms(agg["flops"], agg["bytes"])
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "also_replaces": also, "launches": sum(launches[p].get(name, 0) for p in launches),
            "launches_by_path": {p: launches[p][name] for p in launches if launches[p].get(name)},
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"], "bound_by": b_by,
            "library_ms": agg["library_ms"],
            "eager_ms": agg["eager_ms"], "library_eager_ms": agg["library_eager_ms"],
            "timing": "ms, library_ms: replayed CUDA graphs (device time); eager_ms, "
                      "library_eager_ms, plain_ms: CUDA events around eager calls",
            **({"bound_f32_ms": agg["bound_f32_ms"], "model_err": agg["model_err"],
                "arithmetic": "3 TF32 MMAs per product, f32 accumulate"}
               if name in ("fused_bottleneck", "fused_bottleneck_128", "fused_bottleneck_general")
               else {}),
            **({"arithmetic": "1 bf16 MMA per product, f32 accumulate"}
               if name in ("fused_bottleneck_bf16", "fused_bottleneck_general_bf16") else {}),
            "per": f"times: one call of each recorded path ({', '.join(EXPECTED)}, ingest, "
                   f"h36m, fleet, fleet2, converted, {', '.join(BF16_PATHS)}, converted256, "
                   f"converted256_bf16; the general instance's rows at TOY_SHAPES on no path) "
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
