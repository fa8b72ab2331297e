"""Produce golden-parity fly hourglass weights on the bundled recording.

Counterpart of ``scripts/train_fly_weights.py`` with its flags.  Trains the
port's ``HourglassNet`` so that the serving path (uint8 -> flip -> resize ->
folded forward -> argmax decode -> postprocess) reproduces the golden
``df3d_result_2d.pkl`` within the reference tolerances (points2d atol 0.02,
confidence atol 0.002).

    python -m deepfly3d_torch.train_fly_weights [--steps N] [--resume] [--out F.npz]

The training inputs go through the port's preprocess kernel (identity
registration, as in JAX) and stay on the card; the training forward and
backward are plain PyTorch (cuDNN), as JAX's are XLA.  Every eval folds the
current weights and runs the port's serving path on the card: the
preprocess, bottleneck, upsample-add and decode kernels (the bottleneck's
general instance at a width outside ``ops/bottleneck.INSTANCES``, any width
of its envelope).  ``--dtype bfloat16`` trains and evaluates at bf16, as the
JAX script does: the trainable network computes flax's bf16 graph, and every
eval runs the unfolded bf16 network in eval mode between the preprocess and
decode kernels (JAX's ``infer_batch(fused=False)``), so ``keep_best`` picks
by the bf16 forward the weights were trained through.  ``--device cpu``
runs every kernel's plain version.  The default ``--out`` is the shipped
``weights/hourglass_fly.npz``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepfly3d_torch.io import discovery
from deepfly3d_torch.models import decode as decode_mod
from deepfly3d_torch.models import train as train_mod
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import (HourglassSpec, load_weights, save_weights,
                                              trainable)
from deepfly3d_torch.models.inference import infer_batch
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.utils.devices import full_f32, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "tests", "data", "reference")
GOLDEN = os.path.join(REPO, "tests", "data", "reference_df3d", "df3d_result_2d.pkl")
OUT = os.path.join(REPO, "weights", "hourglass_fly.npz")

NUM_CAMERAS, T = 7, 15


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16000)
    ap.add_argument("--features", type=int, default=96)
    ap.add_argument("--stacks", type=int, default=2)
    ap.add_argument("--stem", choices=["conv", "patchify", "patch8", "patch16"], default="conv",
                    help="'patch16' runs the trunk at 1/8 resolution (with a 2x subpixel head)")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--input", default="256x512", help="network input HxW; heatmaps are input/4")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                    help="trunk compute dtype during training and eval")
    ap.add_argument("--batch-size", type=int, default=24)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sigma", type=float, default=1.25)
    ap.add_argument("--peak-weight", type=float, default=100.0)
    ap.add_argument("--noise", type=float, default=0.008)
    ap.add_argument("--mse-weight", type=float, default=1.0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--shift-aug", type=int, default=0, metavar="K",
                    help="every step rolls the batch by 4*k pixels, k in [-K, K]")
    ap.add_argument("--gain-aug", type=float, default=0.0, metavar="G",
                    help="every step scales the batch by 1+U(-G, G)")
    ap.add_argument("--freeze-bn", action="store_true",
                    help="train against inference-time BN statistics")
    ap.add_argument("--resume", action="store_true", help="fine-tune from --out")
    ap.add_argument("--oversample-hard", type=int, default=0, metavar="N",
                    help="with --resume: images out of tolerance appear N extra times")
    ap.add_argument("--distill-teacher", metavar="NPZ", default=None,
                    help="heatmap targets become a teacher checkpoint's outputs")
    ap.add_argument("--augment-envelope", action="store_true",
                    help="shifted (+-4 px), gain-scaled (0.95/1.05) and JPEG q80 variants of "
                         "every image join the pool (needs --resume)")
    ap.add_argument("--self-distill", action="store_true",
                    help="with --resume: targets become the net's own outputs except the "
                         "failing channels")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    full_f32()

    h, w = (int(v) for v in args.input.split("x"))
    input_shape = (h, w)
    resumed = args.resume and os.path.exists(args.out)
    seed_vars = seed_spec = None
    if resumed:
        seed_vars, seed_spec = load_weights(args.out)
        if seed_spec.input_shape is not None:
            input_shape = tuple(seed_spec.input_shape)
        else:
            seed_spec = dataclasses.replace(seed_spec, input_shape=input_shape)
    hm_shape = (input_shape[0] // 4, input_shape[1] // 4)
    print("device:", dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "",
          flush=True)
    print("input:", input_shape, "heatmaps:", hm_shape, flush=True)

    if resumed:
        spec = dataclasses.replace(seed_spec, compute_dtype=args.dtype)
        print(f"resuming from {args.out} (features={spec.features}, dtype={args.dtype})",
              flush=True)
    else:
        spec = HourglassSpec(num_stacks=args.stacks, features=args.features, depth=args.depth,
                             stem=args.stem, num_classes=19, input_shape=input_shape,
                             head_upsample=2 if args.stem == "patch16" else 1,
                             compute_dtype=args.dtype)

    with open(GOLDEN, "rb") as f:
        golden = pickle.load(f)
    order = list(golden["camera_ordering"])
    flip_cams = {order[i] for i in range(len(order)) if i > 3}
    paths, flips = [], []
    for cam in range(NUM_CAMERAS):
        for img in range(T):
            paths.append(os.path.join(IMAGES, f"camera_{cam}_img_{img}.jpg"))
            flips.append(cam in flip_cams)
    raw = np.stack([discovery.read_image(p) for p in paths])       # (105, 480, 960, 3)
    flips = np.asarray(flips)
    flips_d = torch.from_numpy(flips).to(dev)

    def preprocess(u8: np.ndarray) -> torch.Tensor:
        return image_ops.preprocess_frames(torch.from_numpy(u8).to(dev), flips_d, input_shape)

    def infer(variables, u8, spec_=None):
        """The serving path on ``u8``: -> (pts (C, T, 19, 2), conf (C, T, 19, 1)).
        A float32 spec runs the folded forward; a bf16 one the unfolded
        network in eval mode, the graph it trains (JAX's ``fused=False``)."""
        spec_ = spec_ or spec
        if spec_.compute_dtype == "float32":
            net = FoldedHourglass(fold_hourglass(variables, spec_), spec_).to(dev)
        else:
            net = trainable(variables, spec_, dev)
        pts, conf = infer_batch(net, torch.from_numpy(u8).to(dev), flips_d, input_shape)
        return (pts.cpu().numpy().reshape(NUM_CAMERAS, T, 19, 2),
                conf.cpu().numpy().reshape(NUM_CAMERAS, T, 19, 1))

    def heatmaps(variables, spec_, x):
        """The last stack's heatmaps of the trainable net, eval mode."""
        with torch.no_grad():
            return trainable(variables, spec_, dev)(x)[-1].cpu().numpy()

    images = preprocess(raw)
    print("inputs:", tuple(images.shape), flush=True)

    coords, peaks, known = train_mod.golden_training_targets(
        golden["points2d"], golden["heatmap_confidence"], order)
    coords = coords.reshape(-1, 19, 2)
    peaks = peaks.reshape(-1, 19)
    known = known.reshape(-1, 19)
    targets, peak_cells = train_mod.render_target_heatmaps(coords, peaks, known, hm_shape,
                                                           sigma=args.sigma)

    if args.augment_envelope:
        if args.distill_teacher or args.self_distill:
            raise ValueError("--augment-envelope is not combinable with distillation flags")
        if not resumed:
            raise ValueError("--augment-envelope hardens an existing parity seed: pass "
                             "--resume with --out pointing at the seed checkpoint")
        import cv2

        def reencode(imgs, q):
            return np.stack([cv2.imdecode(cv2.imencode(".jpg", im[:, :, ::-1],
                                                       [cv2.IMWRITE_JPEG_QUALITY, q])[1],
                                          cv2.IMREAD_COLOR)[:, :, ::-1] for im in imgs])

        pool_imgs, pool_coords, peaks_list = [images] * 4, [coords] * 4, [peaks] * 4
        variants = []
        for dx in (-4, 4):
            # right-side cameras are flipped before the network: a +dx raw
            # shift moves their network-frame column by -dx/960
            c2 = coords.copy()
            c2[..., 1] += np.where(flips, -dx / 960.0, dx / 960.0)[:, None]
            variants.append((np.roll(raw, dx, axis=2), c2))
        for gain in (0.95, 1.05):
            variants.append((np.clip(raw.astype(np.float32) * gain, 0, 255).astype(np.uint8),
                             coords))
        variants.append((reencode(raw, 80), coords))
        for raw_v, c_v in variants:
            pool_imgs.append(preprocess(raw_v))
            pool_coords.append(c_v)
            # position-only supervision: the peak targets are the seed's own
            seed_conf = infer(seed_vars, raw_v, seed_spec)[1]
            peaks_list.append(seed_conf.astype(np.float32).reshape(peaks.shape))
        n_rep = len(pool_imgs)
        images = torch.cat(pool_imgs)
        peaks = np.concatenate(peaks_list)
        targets, peak_cells = train_mod.render_target_heatmaps(
            np.concatenate(pool_coords), peaks, np.tile(known, (n_rep, 1)), hm_shape,
            sigma=args.sigma)
        print(f"augment-envelope pool: {images.shape[0]} images ({n_rep - 4} augmented "
              f"variants + 4x clean; augmented peak targets = seed's own confidences)",
              flush=True)

    golden_p2 = golden["points2d"]
    golden_conf = golden["heatmap_confidence"]

    def eval_fn(variables):
        pts, conf = infer(variables, raw)
        p38 = decode_mod.postprocess_points2d(pts, order)
        pts_err = float(np.abs(p38 - golden_p2).max())
        conf_err = float(np.abs(conf - golden_conf).max())
        return {"pts_maxerr": pts_err, "conf_maxerr": conf_err,
                # worst criterion as a fraction of its tolerance; <= 1.0 passes
                "parity_ratio": max(pts_err / 0.02, conf_err / 0.002)}

    keep_metric = "parity_ratio"
    if args.augment_envelope:
        probe_sets = [(np.roll(raw, dx, axis=2), 0.02 + abs(dx) / 960.0) for dx in (-4, 4)]
        probe_sets += [(np.clip(raw.astype(np.float32) * g, 0, 255).astype(np.uint8), 0.02)
                       for g in (0.95, 1.05)]
        base_eval = eval_fn
        gate = {}

        def eval_fn(variables):
            rec = base_eval(variables)
            env_pts = env_conf = 0.0
            for praw, bound in probe_sets:
                pts, conf = infer(variables, praw)
                p38 = decode_mod.postprocess_points2d(pts, order)
                env_pts = max(env_pts, float(np.abs(p38 - golden_p2).max()) / bound)
                env_conf = max(env_conf, float(np.abs(conf - golden_conf).max()))
            # the clean gate is the score-head calibrator's repair region,
            # latched on the first eval (the resumed seed)
            if "conf_ref" not in gate:
                gate["conf_ref"] = max(0.05, rec["conf_maxerr"] + 1e-4)
                gate["pts_ref"] = max(0.03, rec["pts_maxerr"])
            clean_repairable = (rec["pts_maxerr"] <= gate["pts_ref"]
                                and rec["conf_maxerr"] <= gate["conf_ref"])
            rec["env_pts_ratio"] = round(env_pts, 4)
            rec["env_conf"] = round(env_conf, 4)
            rec["hardened_score"] = (env_pts + 0.1 * (rec["pts_maxerr"] / 0.02)
                                     + (0.0 if clean_repairable
                                        else 1000.0 + rec["parity_ratio"]))
            return rec

        keep_metric = "hardened_score"

    if args.distill_teacher:
        t_vars, t_spec = load_weights(args.distill_teacher)
        t_input = tuple(t_spec.input_shape or (256, 512))
        if (t_input[0] // 4, t_input[1] // 4) != hm_shape:
            raise ValueError("teacher heatmap grid must match the student's")
        t_images = images
        if t_input != input_shape:
            t_images = F.interpolate(images.permute(0, 3, 1, 2), size=t_input, mode="bilinear",
                                     antialias=True, align_corners=False).permute(0, 2, 3, 1)
        targets = heatmaps(t_vars, t_spec, t_images)
        print(f"distilling from {args.distill_teacher} (features={t_spec.features}, "
              f"stacks={t_spec.num_stacks})", flush=True)

    if args.self_distill and resumed:
        H, W = hm_shape
        hm = heatmaps(seed_vars, spec, images)                       # (N, H, W, 19)
        flat = hm.transpose(0, 3, 1, 2).reshape(hm.shape[0], 19, H * W)
        arg = flat.argmax(axis=-1)
        dec = np.stack([arg // W / H, arg % W / W], axis=-1)
        pts_bad = known & (np.abs(dec - coords).max(axis=-1) > 0.015)
        conf_bad = np.abs(flat.max(axis=-1) - peaks) > 0.0018
        bad = pts_bad | conf_bad
        print(f"self-distill: {int(pts_bad.sum())} wrong-cell + {int(conf_bad.sum())} conf-bad "
              f"channels get golden targets; {int((~bad).sum())} keep their own output",
              flush=True)
        targets = np.where(bad[:, None, None, :], targets, hm)

    if args.oversample_hard and resumed:
        pts0, conf0 = infer(seed_vars, raw)
        p38_0 = decode_mod.postprocess_points2d(pts0, order)
        perr = np.abs(p38_0 - golden_p2).max(axis=(2, 3))
        cerr = np.abs(conf0 - golden_conf).max(axis=(2, 3))
        hard = np.flatnonzero(np.maximum(perr / 0.02, cerr / 0.002).reshape(-1) > 1.0)
        if hard.size:
            print(f"oversampling {hard.size} hard images x{args.oversample_hard}: "
                  f"{[(int(i) // T, int(i) % T) for i in hard]}", flush=True)
            sel = np.concatenate([np.arange(images.shape[0]),
                                  np.repeat(hard, args.oversample_hard)])
            images = images[torch.from_numpy(sel).to(dev)]
            targets, peak_cells, peaks = targets[sel], peak_cells[sel], peaks[sel]

    cfg = train_mod.TrainConfig(
        learning_rate=args.lr, steps=args.steps, batch_size=args.batch_size, sigma=args.sigma,
        peak_loss_weight=args.peak_weight, noise_scale=args.noise, freeze_bn=args.freeze_bn,
        mse_weight=args.mse_weight, shift_aug=args.shift_aug, gain_aug=args.gain_aug)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    variables, history = train_mod.train_overfit(
        images, targets, peak_cells, peaks, spec, cfg, eval_fn=eval_fn, eval_every=500,
        init_variables=seed_vars, keep_best=keep_metric if args.freeze_bn else None,
        device=dev)
    seconds = time.time() - t0
    print(f"training took {seconds:.1f}s ({history[-1]['step']} steps of {args.batch_size} "
          f"images with the evals)", flush=True)

    if not args.freeze_bn:
        # exact full-data BN statistics close the train/eval gap
        variables = train_mod.recalibrate_batch_stats(variables, spec, images, device=dev)
    final = eval_fn(variables)
    print("final (after BN recalibration):", final, flush=True)
    save_weights(args.out, variables, spec)
    print("saved:", args.out, flush=True)
    ok = final["pts_maxerr"] < 0.02 and final["conf_maxerr"] < 0.002
    print("PARITY:", "PASS" if ok else "FAIL", flush=True)
    marker = args.out + ".PARITY"
    if ok:
        with open(marker, "w") as f:
            f.write(str(final))
    elif os.path.exists(marker):
        os.remove(marker)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
