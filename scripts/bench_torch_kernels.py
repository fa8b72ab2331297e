#!/usr/bin/env python3
"""Time the port's bottleneck, decode and preprocess kernels, one or several checkouts in turns.

    python3 scripts/bench_torch_kernels.py                       # this checkout
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD   # two checkouts, in turns
    python3 scripts/bench_torch_kernels.py --quick               # one launch per shape, no timing
    python3 scripts/bench_torch_kernels.py --match 56x480x960x256x512 --stage-rows 4,8,12
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD --match 56x480x960x256x512,56x480x960x192x384,7x480x960x256x512,8x1000x1000x384x384
    python3 scripts/bench_torch_kernels.py --match 8x1000x1000x384x384 --ring-rows 6,10,14
    python3 scripts/bench_torch_kernels.py --match 8x96x96 --tiles   # sweep the tile height
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD --match 56x128x256,56x64x128,56x32x64,56x16x32,56x8x16,56x4x8
    python3 scripts/bench_torch_kernels.py --match 56x64x128,56x32x64 --tiles   # the bf16 tile table
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD --match 8x192x192,8x96x96,8x48x48,8x24x24,8x12x12,8x6x6
    python3 scripts/bench_torch_kernels.py --match 8x192x192,8x96x96,8x48x48 --tiles   # the 128-wide table
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD --match 56x128x256,56x64x128,56x32x64,56x16x32,56x8x16,56x4x8,7x64x128
    python3 scripts/bench_torch_kernels.py --match 56x128x256,56x64x128,56x32x64,56x16x32,56x8x16 --tiles   # the fly table

Needs one CUDA card.  Each tree runs in its own process (each builds its own
kernels with nvcc): every shape below goes through the tree's
``fused_bottleneck`` / ``decode_heatmaps`` / ``preprocess_resize`` wrapper, is
compared with the tree's plain version (and, where the tree has one, with the
bottleneck's TF32 arithmetic model, 5e-5 of the output's magnitude), and is
timed twice: ``ms`` by CUDA events
around eager calls (the wrapper's host work included, which decides at small
shapes) and ``device_ms`` from a replayed CUDA graph of 20 calls (device time
alone).  The preprocess is timed at the signature every tree has (no shift,
no gain); where the tree's wrapper takes the rig registration's ``shift``
and ``gain``, those are timed as well (``fused_device_ms``), beside the
composition they replace (``unfused_device_ms``: ``apply_shift_tc``'s
gathers, the kernel, the gain multiply), and the fused result must equal
that composition bit for bit; where it takes ``dtype``, the bf16-output
instance is held to one ulp of its plain version and timed bare and fused
(``bf16_device_ms``, ``bf16_fused_device_ms``, ``bf16_bound_ms``).  Each
preprocess shape's inputs come from a generator seeded by the shape, and
the row names the instance the tree runs (``instance``, trees with
``kernels.preprocess_instance_for``).
``--stage-rows`` times the preprocess at other budgets of staged input rows
of the band design, and so other band heights (trees with
``kernels.preprocess_plan``); ``--ring-rows`` at other ring depths of the
run design (trees with ``kernels.PREPROCESS_RING_ROWS``).  Every float32
instance row carries its tile, its bound (three TF32 MMAs per product at 495
TFLOP/s, or its bytes) and cuDNN (``library_ms``: ``F.conv2d``, TF32 off);
the fly network's blocks run at the shapes of its paths (``BLOCK_SHAPES``,
the parity checkpoint's weights), the 64-feature fly network's at
``FLY64_SHAPES`` (seeded weights), and the ``FLY_FORWARD`` line sums each
over the 31 launches of one conv forward at N=56, tree by tree.  The h36m
network's blocks (128 wide) run at the shapes of its ingest path, with weights
from ``utils/synthetic.random_checkpoint`` (seed 0), in the trees that have
those instances, and the stem block also as the raw-input projection, with,
as a yardstick, the general instance
(``csrc/bottleneck_general.cu``) on the same block packed in its own layout
and launched through its C entry point at the tile its table picks
(``general_ms``); the ``H36M_BATCH`` line sums them over the 59 launches of
one h36m batch of 8, tree by tree.  The converted 256-wide path's blocks (``GENERAL_SHAPES``)
run the general instance in float32 and bf16 in every tree that has it, held
to the tree's plain version (float32 5e-5 of the output's magnitude, bf16 2
bf16 ulps) and timed as device time, with the weight bytes a launch streams
from L2 (``general_l2_bytes``, by the tree's own layout).  The bf16 resident instance
runs at ``BF16_SHAPES`` (``bf16_rows``: 2 bf16 ulps of its plain version,
device time, bound, cuDNN bf16), and its sum over one ``conv_bf16`` forward
is printed per tree (``FORWARD`` line).  Every preprocess output (float32 and
bf16, each bare and with the registration) is hashed (``out_sha``), and after
the last tree the outputs of each shape are compared across the trees: the
script fails where they differ (``COMPARE`` line; the float32 bottleneck rows'
bits follow each design's order of sums, so they are held to the plain
version and the TF32 model instead).  ``--tiles`` times every tile height that
fits, per bottleneck shape (``tile_ms``), and prints the fly and the 128-wide
instances' tables (``FLY_TILE_TABLE``, ``WIDE_TILE_TABLE``).  One JSON line per
tree, prefixed ``RESULT``; the card's name and power limit first.  Comparing
two versions is only meaningful inside one call, on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile

# (N, H, W, block): the shapes the conv, p16 and cascade paths give the kernel
BLOCK_SHAPES = [
    (56, 128, 256, "stem_res1"), (56, 64, 128, "stem_res2"), (56, 48, 96, "stem_res2"),
    (56, 32, 64, "stem_res2"), (56, 24, 48, "stem_res2"), (56, 16, 32, "stem_res2"),
    (56, 12, 24, "stem_res2"), (56, 8, 16, "stem_res2"), (56, 6, 12, "stem_res2"),
    (56, 4, 8, "stem_res2"), (56, 3, 6, "stem_res2"), (56, 2, 4, "stem_res2"),
    (7, 128, 256, "stem_res1"), (7, 64, 128, "stem_res2"), (7, 32, 64, "stem_res2"),
    (7, 16, 32, "stem_res2"), (7, 8, 16, "stem_res2"), (7, 4, 8, "stem_res2"),
    (3, 13, 21, "stem_res2"),
]
# (N, H, W, block): the 64-feature fly network (seeded weights): its projecting
# stem block 32->32->64 at 128x256 and its 64->32->64 blocks from 64x128 down
FLY64_SHAPES = [(56, 128, 256, "stem_res1")] + [(56, h, 2 * h, "stem_res2")
                                               for h in (64, 32, 16, 8, 4)]
# launches of each shape per conv forward at N=56: 31 blocks, the stem block
# and six at each of the five levels 64x128 ... 4x8
CONV_LAUNCHES = {(56, 128, 256): 1, (56, 64, 128): 6, (56, 32, 64): 6, (56, 16, 32): 6,
                 (56, 8, 16): 6, (56, 4, 8): 6}
# the h36m network at the CLI's batch of 8 images: the projecting stem block at
# 192x192, the 128-wide blocks from 96x96 down to 6x6
H36M_SHAPES = [(8, 192, 192, "stem_res1"), (8, 96, 96, "stem_res2"), (8, 48, 48, "stem_res2"),
               (8, 24, 24, "stem_res2"), (8, 12, 12, "stem_res2"), (8, 6, 6, "stem_res2")]
H36M_SPEC = dict(num_stacks=4, features=128, depth=4, num_classes=17, input_shape=(384, 384))
# launches of each h36m shape per batch of 8 (the stem block once, then the
# 128->64->128 blocks of the four stacks by level): 59
H36M_LAUNCHES = {(8, 192, 192): 1, (8, 96, 96): 10, (8, 48, 48): 12, (8, 24, 24): 12,
                 (8, 12, 12): 12, (8, 6, 6): 12}
PEAK_TF32_FLOPS = 495e12        # TF32 dense, one H100 SXM
NUM_SMS = 132                   # H100 SXM
# (N, H, W, Cin, Cmid, Cout, projection, raw): the converted 256-wide path's
# blocks, which run the general instance (the raw projecting stem block, then
# the 256->128->256 blocks from 64x128 down to 4x8), float32 and bf16
GENERAL_SHAPES = [(56, 128, 256, 128, 128, 256, True, True)] + [
    (56, h, 2 * h, 256, 128, 256, False, False) for h in (64, 32, 16, 8, 4)]
# (N, H, W, Cin, Cmid, Cout, projection): the bf16 resident instance at the bf16
# paths' shapes (conv_bf16 and p16_bf16: the projecting stem block at 128x256,
# the 96->48->96 blocks from 64x128 down to 2x4; cascade_bf16: the student's
# levels 48x96 ... 3x6 and the teacher's 7 images) and at the h36m network's
# 128-wide blocks at its batch of 8 (on no bf16 path yet)
BF16_SHAPES = ([(n, 128, 256, 48, 48, 96, True) for n in (56, 7)]
               + [(56, h, 2 * h, 96, 48, 96, False) for h in (64, 48, 32, 24, 16, 12, 8, 6, 4, 3, 2)]
               + [(7, h, 2 * h, 96, 48, 96, False) for h in (64, 32, 16, 8, 4)]
               + [(8, 192, 192, 64, 64, 128, True)]
               + [(8, h, h, 128, 64, 128, False) for h in (96, 48, 24, 12, 6)])
PEAK_BF16_FLOPS = 989e12        # bf16 dense, one H100 SXM
DECODE_SHAPES = [(56, 64, 128, 19), (56, 48, 96, 19), (7, 64, 128, 19), (5, 7, 9, 19),
                 (3, 16, 32, 6)]
# (N, H, W, h, w): the conv and p16 paths, the cascade's student and teacher,
# identity mode (the TPU kernel's function; on no path), rows of 150 bytes and
# the h36m path's batch of 8 frames of 1000x1000
PREPROCESS_SHAPES = [(56, 480, 960, 256, 512), (56, 480, 960, 192, 384), (7, 480, 960, 256, 512),
                     (56, 480, 960, 480, 960), (3, 37, 50, 13, 29), (8, 1000, 1000, 384, 384)]
PEAK_BYTES = 3.35e12            # HBM3 of one H100 SXM


def cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20, replays=5):
    """Device time of one ``fn()``: ``iters`` calls captured into a CUDA graph and
    replayed, so that no host work sits between the launches."""
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _sha(t):
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def preprocess_rows(torch, kernels, image_ops, shape, dev, quick, no_check, budget, ring):
    """Check and time one preprocess shape; -> the result row.  The inputs
    come from a generator seeded by the shape, so every tree gets the same
    frames and registration; each output's hash (float32 and, where the tree
    has it, bf16, each bare and with the registration) goes into ``out_sha``."""
    n, h_in, w_in, h, w = shape
    gen = torch.Generator().manual_seed(n * 1000003 + h_in * 1009 + w_in * 31 + h * 7 + w)
    x = torch.randint(0, 256, (n, h_in, w_in, 3), generator=gen, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 3 == 1).to(dev)
    iters = 1 if quick else 20
    identity = (h, w) == (h_in, w_in)
    params = inspect.signature(kernels.preprocess_resize).parameters
    row = {"kernel": "preprocess", "shape": list(shape),
           "bound_ms": (x.numel() + 4 * n * h * w * 3) / PEAK_BYTES * 1e3, "out_sha": {}}
    if budget:
        row["plan"] = list(kernels.preprocess_plan(h_in, w_in, 3, h, w, budget))
    if ring is not None or hasattr(kernels, "preprocess_run_plan"):
        row["run_plan"] = list(kernels.preprocess_run_plan(n, h_in, w_in, 3, h, w, ring))
    out = kernels.preprocess_resize(x, flip, (h, w))
    torch.cuda.synchronize()
    if hasattr(kernels, "preprocess_instance_for"):     # the same for both dtypes
        row["instance"] = kernels.preprocess_instance_for(x, out)
    row["out_sha"]["f32"] = _sha(out)
    if identity:
        row["err_plain"] = (out - kernels.preprocess_u8_plain(x, flip)).abs().max().item()
    else:
        ref = image_ops.preprocess_frames_plain(x, flip, (h, w))
        row["err_plain"] = (out - ref).abs().max().item()
    if not no_check and not row["err_plain"] <= (0.0 if identity else 2e-6):
        raise AssertionError(f"preprocess {row}")
    if not quick:
        row["ms"] = cuda_ms(torch, lambda: kernels.preprocess_resize(x, flip, (h, w)), iters)
        row["device_ms"] = graph_ms(torch, lambda: kernels.preprocess_resize(x, flip, (h, w)))
    if "shift" not in params:
        return row
    from deepfly3d_torch.ops import canonicalize

    dy = torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
    dx = torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
    gain = (0.9 + 0.2 * torch.rand(n, generator=gen)).to(dev)
    gain[::4] = 1.0

    def fused(dtype="float32"):
        kw = {"dtype": dtype} if dtype != "float32" else {}
        return kernels.preprocess_resize(x, flip, (h, w), shift=(dy, dx), gain=gain, **kw)

    def unfused():
        rolled = canonicalize.apply_shift_tc(x[None], dy, dx)[0]
        return kernels.preprocess_resize(rolled, flip, (h, w)) * gain[:, None, None, None]

    got = fused()
    row["out_sha"]["f32+reg"] = _sha(got)
    row["fused_equal"] = torch.equal(got, unfused())
    if not no_check and not row["fused_equal"]:
        raise AssertionError(f"preprocess {row}: fused != unfused composition")
    if not quick:
        row["fused_device_ms"] = graph_ms(torch, fused)
        row["unfused_device_ms"] = graph_ms(torch, unfused)
    if "dtype" not in params:
        return row
    # the bf16-output instance: within one ulp of its plain version, bare and
    # with the registration
    row["bf16_bound_ms"] = (x.numel() + 2 * n * h * w * 3) / PEAK_BYTES * 1e3
    for label, reg in (("bf16", {}), ("bf16+reg", {"shift": (dy, dx), "gain": gain})):
        got = kernels.preprocess_resize(x, flip, (h, w), dtype="bfloat16", **reg)
        want = image_ops.preprocess_frames_plain(x, flip, (h, w), "bfloat16", **reg).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        row[f"{label}_ulps"] = ((got.float() - want).abs() / ulp).max().item()
        if not no_check and not row[f"{label}_ulps"] <= 1.0:
            raise AssertionError(f"preprocess {row}: {label} more than one ulp off")
        row["out_sha"][label] = _sha(got)
    if not quick:
        row["bf16_device_ms"] = graph_ms(
            torch, lambda: kernels.preprocess_resize(x, flip, (h, w), dtype="bfloat16"))
        row["bf16_fused_device_ms"] = graph_ms(torch, lambda: fused("bfloat16"))
    return row


def seeded_block(np, cin, cmid, cout, seed=0):
    """One Bottleneck's flax-layout collections with weights at a trained
    net's scale, from a seed (the same arrays in every tree)."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return ({"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                 "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)},
                {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    def conv(k, ci, co):
        w = rng.standard_normal((k, k, ci, co)).astype(np.float32) / np.sqrt(k * k * ci)
        return {"kernel": w, "bias": rng.uniform(-0.05, 0.05, co).astype(np.float32)}

    params, stats = {}, {}
    for name, c in (("bn1", cin), ("bn2", cmid), ("bn3", cmid)):
        params[name], stats[name] = bn(c)
    params.update(conv1=conv(1, cin, cmid), conv2=conv(3, cmid, cmid), conv3=conv(1, cmid, cout),
                  proj=conv(1, cin, cout))
    return params, stats


def general_l2_bytes(key, tile, dtype, design):
    """Weight bytes one launch of the general instance streams from L2 at
    ``key`` = (N, H, W, Cin, Cmid, Cout, projection, raw) with output tiles
    ``tile``: every tile streams each weight once per pass of its stage's rows
    (stage 1 over the (th+2) x (tw+2) halo, stages 2 and 3 over the tile).
    ``design`` "wgmma" (the current layout: float32 weights as hi and lo, 8
    bytes each, bf16 2; passes of 128 rows, 256 at bf16 on tiles of more than
    128 pixels, 128 in stage 3 of a projecting bf16 block) or "mma" (the
    design before it: 4 bytes, bf16 2; passes of 128 rows)."""
    n, h, w, cin, cmid, cout, proj, _ = key
    th, tw = tile
    bf16 = dtype == "bfloat16"
    e = 2 if bf16 else (8 if design == "wgmma" else 4)
    rows = 256 if design == "wgmma" and bf16 and th * tw > 128 else 128
    rows3 = 128 if bf16 and proj else rows
    hp, tp = (th + 2) * (tw + 2), th * tw
    per_tile = e * (-(-hp // rows) * cin * cmid + -(-tp // rows) * 9 * cmid * cmid
                    + -(-tp // rows3) * (cmid * cout + (cin * cout if proj else 0)))
    return n * -(-h // th) * -(-w // tw) * per_tile


def general_rows(torch, np, bn, dev, quick, no_check, match, model):
    """The general instance at GENERAL_SHAPES, float32 and bf16: against the
    tree's plain version (float32 5e-5 of the output's magnitude, and its
    TF32 model; bf16 2 bf16 ulps), timed like the other bottleneck rows, with
    its L2 bytes per launch beside (``general_l2_bytes``)."""
    rows = []
    design = "wgmma" if hasattr(bn, "_pack_wgmma") else "mma"     # the tree's layout
    for key in GENERAL_SHAPES:
        n, h, w, cin, cmid, cout, proj, raw = key
        if match is not None and "x".join(map(str, key[:3])) not in match:
            continue
        params, stats = seeded_block(np, cin, cmid, cout)
        if not proj:
            params.pop("proj")
        for dtype in ("float32", "bfloat16"):
            f = {k: v.to(dev) for k, v in bn.add_packed(
                bn.fold_bottleneck(params, stats, raw, dtype)).items()}
            seed = torch.Generator().manual_seed(n * 1000003 + h * 1009 + w)
            x = torch.randn((n, h, w, cin), generator=seed).to(dev).to(getattr(torch, dtype))
            y = bn.fused_bottleneck(x, f)
            torch.cuda.synchronize()
            ref = bn.bottleneck_plain(x, f).float()
            mag = ref.abs().max().item()
            tile = list(bn.choose_tile(n, h, w, cin, cmid, cout, proj, dtype))
            row = {"kernel": "bottleneck_general", "dtype": dtype, "shape": [n, h, w],
                   "channels": [cin, cmid, cout], "proj": proj, "raw": raw, "tile": tile,
                   "scale": mag, "err_plain": (y.float() - ref).abs().max().item(),
                   "l2_bytes": general_l2_bytes(key, tile, dtype, design)}
            if dtype == "float32":
                tol = 5e-5 * max(1.0, mag)
                if model is not None:
                    row["err_model"] = (y - model(x, f)).abs().max().item()
            else:
                tol = 2 * 2.0 ** (np.floor(np.log2(mag)) - 7)
            if not no_check and not max(row["err_plain"], row.get("err_model", 0.0)) <= tol:
                raise AssertionError(f"general bottleneck {row} (tolerance {tol})")
            if not quick:
                row["device_ms"] = graph_ms(torch, lambda: bn.fused_bottleneck(x, f), iters=5,
                                            replays=4)
            rows.append(row)
            print(row, flush=True)
            del x, y, ref
            torch.cuda.empty_cache()
    return rows


def block_library(torch, F, x, f, raw=False):
    """One cuDNN chain (``F.conv2d``, channels-last) that computes the folded
    block, as chip_smoke.py's library call."""
    cmid = f["w1"].shape[1]
    lw = {k: f[k].t().contiguous()[:, :, None, None] for k in ("w1", "w3", "wp") if k in f}
    lw["w2"] = f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1).contiguous()
    lb = {k: f[k][0].to(x.dtype) for k in ("b1", "b2", "b3", "bp") if k in f}

    def library():
        xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW view
        a1 = torch.relu(xc * f["s1"].view(1, -1, 1, 1) + f["t1"].view(1, -1, 1, 1))
        a2 = torch.relu(F.conv2d(a1, lw["w1"], lb["b1"]))
        a3 = torch.relu(F.conv2d(a2, lw["w2"], lb["b2"], padding=1))
        z = F.conv2d(a3, lw["w3"], lb["b3"])
        return z + (F.conv2d(xc if raw else a1, lw["wp"], lb["bp"]) if "wp" in f else xc)

    return library


def general_yardstick(torch, bn, _build, x, f, raw):
    """The general instance on this block: its own packed layout, its tile by
    its table's rule, launched through its C entry point -> (call, tile)."""
    import ctypes

    import numpy as np

    n, h, w, cin = x.shape
    cmid, cout, proj = f["w1"].shape[1], f["w3"].shape[1], "wp" in f
    packed = bn._pack_general({k: v.detach().cpu().float().numpy() for k, v in f.items()
                               if k not in ("packed", "proj_raw")}, "float32").to(x.device)
    lib = _build.library("bottleneck_general")
    smem = lib.df3d_bottleneck_general_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_int
    fn = lib.df3d_bottleneck_general
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tw, best = min(bn.TILE_MAX_WIDTH, w), None
    for th in range(1, h + 1):
        if th * tw > bn.GENERAL_TILE_PIXELS["float32"] or smem(cin, cmid, cout, th, tw, 0) > bn.MAX_SMEM:
            break
        cost = -(-n * -(-h // th) * -(-w // tw) // bn.NUM_SMS) * bn._TILE_US_GENERAL[-(-th * tw // 16)]
        if best is None or cost < best[0]:
            best = (cost, th)
    th = best[1]
    y = torch.empty((n, h, w, cout), device=x.device)

    def call():
        rc = fn(x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout, int(proj),
                int(raw), th, tw, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"general instance: CUDA error {rc}")
        return y

    ref = bn.bottleneck_plain(x, f)
    err = (call() - ref).abs().max().item()
    if not err <= 5e-5 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"general yardstick {tuple(x.shape)}: err {err}")
    return call, [th, tw]


def sweep_tiles(bn, x, f, device_ms, dtype="float32"):
    """{"th x tw": device ms} of every tile height that fits, the wrapper's own
    choice of tile put aside for the sweep (at bf16, the tree's limits of its
    bf16 instance where it has them)."""
    n, h, w, cin = x.shape
    cmid, cout, proj = f["w1"].shape[1], f["w3"].shape[1], "wp" in f
    chosen, tw = bn.choose_tile, min(bn.TILE_MAX_WIDTH, w)
    resident16 = dtype == "bfloat16" and hasattr(bn, "bf16_tile_fits")
    wide = (dtype == "float32" and hasattr(bn, "tile_fits_128")
            and bn.streams_w2(cin, cmid, cout, proj))
    fly = dtype == "float32" and hasattr(bn, "tile_fits_fly") and not wide
    out = {}
    try:
        for th in range(1, h + 1):
            if resident16:
                if not bn.bf16_tile_fits(th, tw, cin, cmid, cout, proj):
                    break
            elif wide:
                if not bn.tile_fits_128(th, tw, cin, proj):
                    break
            elif fly:
                if not bn.tile_fits_fly(th, tw, cin, cmid, cout, proj):
                    break
            elif (bn.smem_bytes(cin, cmid, cout, th, tw, proj, dtype) > bn.MAX_SMEM
                  or th * tw > 16 * getattr(bn, "TILE_WARPS", 12)):
                break
            bn.choose_tile = lambda *args, th=th: (th, tw)
            out[f"{th}x{tw}"] = device_ms(lambda: bn.fused_bottleneck(x, f))
    finally:
        bn.choose_tile = chosen
    return out


def bf16_rows(torch, np, F, bn, dev, quick, no_check, match, tiles):
    """The bf16 resident instance at BF16_SHAPES (seeded weights at a trained
    net's scale): held to the tree's plain version within 2 bf16 ulps of the
    output's largest magnitude, timed as device time, beside its byte bound
    (x and y at 2 bytes, the weights once; 989 TFLOP/s) and cuDNN in native
    bf16 (``F.conv2d``, channels-last, the same chain as chip_smoke.py's
    library call).  ``tiles``: every tile height that fits (``tile_ms``) and
    ``tile_us``, the launch's time over its rounds of two tiles per SM (the
    quantity ``ops/bottleneck._TILE_US_BF16`` tabulates)."""
    rows = []
    for key in BF16_SHAPES:
        n, h, w, cin, cmid, cout, proj = key
        if match is not None and "x".join(map(str, key[:3])) not in match:
            continue
        if (cin, cmid, cout, proj) not in getattr(bn, "INSTANCES", ()):
            continue
        params, stats = seeded_block(np, cin, cmid, cout)
        if not proj:
            params.pop("proj")
        f = {k: v.to(dev) for k, v in bn.add_packed(
            bn.fold_bottleneck(params, stats, False, "bfloat16")).items()}
        seed = torch.Generator().manual_seed(n * 1000003 + h * 1009 + w)
        x = torch.randn((n, h, w, cin), generator=seed).to(dev).to(torch.bfloat16)
        y = bn.fused_bottleneck(x, f)
        torch.cuda.synchronize()
        ref = bn.bottleneck_plain(x, f).float()
        mag = ref.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        flops = 2.0 * n * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                                   + (cin * cout if proj else 0))
        nbytes = 2 * (n * h * w * (cin + cout) + flops / (2.0 * n * h * w)) + 4.0 * (
            2 * cin + 2 * cmid + cout + (cout if proj else 0))
        th, tw = bn.choose_tile(n, h, w, cin, cmid, cout, proj, "bfloat16")
        row = {"kernel": "bottleneck_bf16", "shape": [n, h, w], "channels": [cin, cmid, cout],
               "proj": proj, "tile": [th, tw], "scale": mag,
               "err_ulps": (y.float() - ref).abs().max().item() / ulp,
               "share_differing": (y.float() != ref).float().mean().item(),
               "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3}
        if not no_check and not row["err_ulps"] <= 2:
            raise AssertionError(f"bf16 bottleneck {row}")
        if not quick:
            lw = {k: f[k].t().contiguous()[:, :, None, None] for k in ("w1", "w3", "wp") if k in f}
            lw["w2"] = f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1).contiguous()
            lb = {k: f[k][0].to(x.dtype) for k in ("b1", "b2", "b3", "bp") if k in f}

            def library():
                xc = x.permute(0, 3, 1, 2)                  # channels_last NCHW view
                a1 = torch.relu(xc * f["s1"].view(1, -1, 1, 1) + f["t1"].view(1, -1, 1, 1))
                a2 = torch.relu(F.conv2d(a1, lw["w1"], lb["b1"]))
                a3 = torch.relu(F.conv2d(a2, lw["w2"], lb["b2"], padding=1))
                z = F.conv2d(a3, lw["w3"], lb["b3"])
                return z + (F.conv2d(a1, lw["wp"], lb["bp"]) if proj else xc)

            row["device_ms"] = graph_ms(torch, lambda: bn.fused_bottleneck(x, f))
            row["library_ms"] = graph_ms(torch, library)
            if tiles:
                row["tile_ms"] = sweep_tiles(bn, x, f, lambda fn: graph_ms(torch, fn), "bfloat16")
                row["tile_us"], row["tile_rounds"] = {}, {}
                for tile, ms in row["tile_ms"].items():
                    t_h, t_w = map(int, tile.split("x"))
                    per_sm = -(-n * -(-h // t_h) * -(-w // t_w) // bn.NUM_SMS)
                    row["tile_rounds"][tile] = -(-per_sm // 2)
                    row["tile_us"][tile] = 1e3 * ms / row["tile_rounds"][tile]
        rows.append(row)
        print(row, flush=True)
        del x, y, ref
        torch.cuda.empty_cache()
    return rows


def run_tree(root, quick, no_check=False, match=None, budgets=None, h36m=None, tiles=False,
             rings=None):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models.fused_inference import fold_hourglass
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.ops import _build, kernels
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.utils.devices import full_f32
    import numpy as np

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    full_f32()
    dev = torch.device("cuda", 0)
    for name, log in _build.build().items():
        for line in log.splitlines():
            if any(word in line for word in ("registers", "spill", "error", "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    blocks = fold_hourglass(*load_weights(os.path.join(WEIGHTS_DIR, "hourglass_fly.npz")))["blocks"]
    wide = fold_hourglass(*load_weights(h36m))["blocks"] if h36m else {}
    fly64 = {}
    for name, (cin, cmid, cout) in (("stem_res1", (32, 32, 64)), ("stem_res2", (64, 32, 64))):
        params, stats = seeded_block(np, cin, cmid, cout)
        if cin == cout:
            params.pop("proj")
        fly64[name] = bn.fold_bottleneck(params, stats)
    pack = getattr(bn, "add_packed", lambda f: f)
    model = getattr(bn, "bottleneck_tf32_model", None)
    gen = torch.Generator().manual_seed(0)
    iters = 1 if quick else 20
    rows = []
    picked = lambda *shape: match is None or "x".join(map(str, shape)) in match
    instances = getattr(bn, "INSTANCES", ())
    import torch.nn.functional as F

    shapes = ([(s, blocks, False) for s in BLOCK_SHAPES] + [(s, fly64, False) for s in FLY64_SHAPES]
              + [(s, wide, False) for s in H36M_SHAPES]
              + [(s, wide, True) for s in H36M_SHAPES if s[3] == "stem_res1"])
    for (n, h, w, name), net, raw in shapes:
        if not picked(n, h, w) or name not in net:
            continue
        folded = net[name]
        cin, cmid, cout = folded["w1"].shape[0], folded["w1"].shape[1], folded["w3"].shape[1]
        if net is wide and (cin, cmid, cout, "wp" in folded) not in instances:
            continue                                  # a tree without the 128-wide instances
        if raw:
            folded = {**{k: v for k, v in folded.items() if k != "packed"},
                      "proj_raw": torch.ones((), dtype=torch.bool)}
        f = {k: v.to(dev) for k, v in pack(folded).items()}
        seed = torch.Generator().manual_seed(n * 1000003 + h * 1009 + w)   # per shape
        x = torch.randn((n, h, w, cin), generator=seed).to(dev)
        y = bn.fused_bottleneck(x, f)
        torch.cuda.synchronize()
        ref = bn.bottleneck_plain(x, f)
        row = {"kernel": "bottleneck", "shape": [n, h, w], "block": name + ("/raw" if raw else ""),
               "net": "h36m" if net is wide else "fly64" if net is fly64 else "fly",
               "channels": [cin, cmid, cout], "proj": "wp" in folded,
               "scale": ref.abs().max().item(), "err_plain": (y - ref).abs().max().item()}
        if model is not None:
            row["err_model"] = (y - model(x, f)).abs().max().item()
        tol = 5e-5 * max(1.0, row["scale"])
        if not no_check and not (row["err_plain"] <= tol and row.get("err_model", 0.0) <= tol):
            raise AssertionError(f"bottleneck {row}")
        row["tile"] = list(bn.choose_tile(n, h, w, cin, cmid, cout, "wp" in folded))
        flops = 2.0 * n * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                                   + (cin * cout if "wp" in folded else 0))
        nbytes = 4.0 * (n * h * w * (cin + cout) + flops / (2.0 * n * h * w))
        row["bound_ms"] = max(3.0 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        if not quick:
            row["ms"] = cuda_ms(torch, lambda: bn.fused_bottleneck(x, f), iters)
            row["device_ms"] = graph_ms(torch, lambda: bn.fused_bottleneck(x, f))
            row["plain_ms"] = cuda_ms(torch, lambda: bn.bottleneck_plain(x, f), iters)
            row["library_ms"] = graph_ms(torch, block_library(torch, F, x, f, raw))
            if net is wide:
                if hasattr(bn, "_pack_general"):
                    call, row["general_tile"] = general_yardstick(torch, bn, _build, x, f, raw)
                    row["general_ms"] = graph_ms(torch, call)
            if tiles:
                row["tile_ms"] = sweep_tiles(bn, x, f, lambda fn: graph_ms(torch, fn))
        rows.append(row)
        print(row, flush=True)
        del x, y, ref
        torch.cuda.empty_cache()
    if hasattr(bn, "kernel_for"):                     # a tree with the general instance
        rows += general_rows(torch, np, bn, dev, quick, no_check, match, model)
    rows += bf16_rows(torch, np, F, bn, dev, quick, no_check, match, tiles)
    for shape in DECODE_SHAPES:
        n, h, w, k = shape
        if not picked(*shape):
            continue
        hm = torch.randn(shape, generator=gen)
        hm[0, :, :, 0] = 1.0
        hm[1 % n, 1, 2, 1] = hm[1 % n, h - 2, w - 3, 1] = 7.0
        hm[2 % n, 2, 1, 2] = float("nan")
        hm[2 % n, :, :, 3] = -0.0
        hm[2 % n, h - 1, 1, 3] = 0.0
        hm = hm.to(dev)
        pts, conf = kernels.decode_heatmaps(hm)
        torch.cuda.synchronize()
        rp, rc = kernels.decode_heatmaps_plain(hm)
        ok = torch.equal(pts, rp) and torch.equal(conf.nan_to_num(nan=123.0),
                                                  rc.nan_to_num(nan=123.0))
        row = {"kernel": "decode", "shape": list(shape), "equal": ok}
        if not ok:
            raise AssertionError(f"decode {row}")
        if not quick:
            flat = hm.view(n, h * w, k)
            row["ms"] = cuda_ms(torch, lambda: kernels.decode_heatmaps(hm), 50)
            row["library_ms"] = cuda_ms(torch, lambda: torch.max(flat, dim=1), 50)
            row["device_ms"] = graph_ms(torch, lambda: kernels.decode_heatmaps(hm))
            row["library_device_ms"] = graph_ms(torch, lambda: torch.max(flat, dim=1))
        rows.append(row)
        print(row, flush=True)
    default = getattr(kernels, "PREPROCESS_STAGE_ROWS", None)
    default_ring = getattr(kernels, "PREPROCESS_RING_ROWS", None)
    has_ring = hasattr(kernels, "PREPROCESS_RING_ROWS")
    for shape in PREPROCESS_SHAPES:
        if not picked(*shape):
            continue
        plans = [(default, default_ring)]
        plans += [(b, default_ring) for b in (budgets or []) if default and b != default]
        plans += [(default, r) for r in (rings or []) if has_ring]
        for budget, ring in plans:
            kernels.PREPROCESS_STAGE_ROWS = budget
            if has_ring:
                kernels.PREPROCESS_RING_ROWS = ring
            rows.append(preprocess_rows(torch, kernels, image_ops, shape, dev, quick,
                                        no_check, budget, ring))
            if (budget, ring) != plans[0]:
                rows[-1].pop("out_sha")       # the comparison across trees takes the default
            print(rows[-1], flush=True)
            torch.cuda.empty_cache()
        kernels.PREPROCESS_STAGE_ROWS = default
        if has_ring:
            kernels.PREPROCESS_RING_ROWS = default_ring
    print("RESULT " + json.dumps({"tree": root, "rows": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-check", action="store_true",
                    help="time a deliberately wrong experimental kernel: skip the tolerance")
    ap.add_argument("--match", help="comma-separated shapes to run, as 56x64x128 (a block), "
                                    "56x64x128x19 (a decode) or 56x480x960x256x512 (a preprocess); "
                                    "default all")
    ap.add_argument("--stage-rows", help="comma-separated budgets of staged input rows per "
                                         "preprocess band to time")
    ap.add_argument("--ring-rows", help="comma-separated ring depths (input rows) of the "
                                        "preprocess's run design to time")
    ap.add_argument("--tiles", action="store_true",
                    help="time every tile height that fits, per bottleneck shape")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--h36m", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_tree(args.one, args.quick, args.no_check,
                        args.match.split(",") if args.match else None,
                        [int(r) for r in args.stage_rows.split(",")] if args.stage_rows else None,
                        args.h36m, args.tiles,
                        [int(r) for r in args.ring_rows.split(",")] if args.ring_rows else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        h36m = os.path.join(tmp, "hourglass_h36m_seed0.npz")
        random_checkpoint(h36m, 0, **H36M_SPEC)
        for tree in args.trees:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--h36m", h36m]
            cmd += (["--quick"] if args.quick else []) + (["--no-check"] if args.no_check else [])
            cmd += ["--match", args.match] if args.match else []
            cmd += ["--stage-rows", args.stage_rows] if args.stage_rows else []
            cmd += ["--ring-rows", args.ring_rows] if args.ring_rows else []
            cmd += ["--tiles"] if args.tiles else []
            with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True) as proc:
                for line in proc.stdout:
                    print(line, end="", flush=True)
                    if line.startswith("RESULT "):
                        results.append(json.loads(line[len("RESULT "):]))
            if proc.returncode:
                raise SystemExit(f"tree {tree} failed ({proc.returncode})")
    # every preprocess output, shape by shape, across the trees that ran it (the
    # bottleneck instances are held to their plain version and TF32 model
    # instead: their bits follow each design's order of sums)
    outputs = {}
    for result in results:
        for row in result["rows"]:
            where = "x".join(map(str, row["shape"]))
            if row["kernel"] == "preprocess":       # float32 and bf16, bare and registered
                for label, sha in row.get("out_sha", {}).items():
                    outputs.setdefault(f"preprocess/{label}@{where}", {})[result["tree"]] = sha
    differ = {k: v for k, v in outputs.items() if len(set(v.values())) > 1}
    # the bf16 resident instance per conv_bf16 forward, tree by tree
    forward = []
    for result in results:
        got = {tuple(r["shape"]): r for r in result["rows"] if r["kernel"] == "bottleneck_bf16"}
        if all(k in got and "device_ms" in got[k] for k in CONV_LAUNCHES):
            forward.append({"tree": result["tree"], **{
                key: sum(got[k][key] * c for k, c in CONV_LAUNCHES.items())
                for key in ("device_ms", "bound_ms", "library_ms")}})
    if forward:
        print("FORWARD " + json.dumps(forward), flush=True)
    # the float32 fly networks' blocks per conv forward at N=56 (31 launches),
    # tree by tree: the parity checkpoint's 96-wide net and the 64-wide one
    fly_forward = []
    for result in results:
        for net in ("fly", "fly64"):
            got = {tuple(r["shape"]): r for r in result["rows"]
                   if r["kernel"] == "bottleneck" and r.get("net") == net and "/" not in r["block"]}
            if all(k in got and "device_ms" in got[k] for k in CONV_LAUNCHES):
                fly_forward.append({"tree": result["tree"], "net": net, **{
                    key: sum(got[k][key] * c for k, c in CONV_LAUNCHES.items())
                    for key in ("device_ms", "bound_ms", "plain_ms", "library_ms")}})
    if fly_forward:
        print("FLY_FORWARD " + json.dumps(fly_forward), flush=True)
    # the 128-wide float32 blocks per h36m batch of 8 (59 launches), tree by tree
    batch = []
    for result in results:
        got = {tuple(r["shape"]): r for r in result["rows"]
               if r["kernel"] == "bottleneck" and r["block"] in ("stem_res1", "stem_res2")}
        if all(k in got and "device_ms" in got[k] for k in H36M_LAUNCHES):
            batch.append({"tree": result["tree"], **{
                key: sum(got[k][key] * c for k, c in H36M_LAUNCHES.items())
                for key in ("device_ms", "bound_ms", "library_ms", "general_ms")
                if all(key in got[k] for k in H36M_LAUNCHES)}})
    if batch:
        print("H36M_BATCH " + json.dumps(batch), flush=True)
    # with --tiles: the fly (Cmid 48) and the 128-wide (Cmid 64) instances'
    # tables, per m 16-pixel row tiles of the tile, the median of the launch's
    # time over its rounds of one tile per SM over the shapes of more than one
    # round, tree by tree
    for label, mid in (("FLY_TILE_TABLE", 48), ("WIDE_TILE_TABLE", 64)):
        for result in results:
            per = {}
            for r in result["rows"]:
                if r["kernel"] != "bottleneck" or r["channels"][1] != mid:
                    continue
                n, h, w = r["shape"]
                for tile, ms in r.get("tile_ms", {}).items():
                    t_h, t_w = map(int, tile.split("x"))
                    rounds = -(-n * -(-h // t_h) * -(-w // t_w) // NUM_SMS)
                    if rounds > 1:
                        per.setdefault(-(-t_h * t_w // 16), []).append(1e3 * ms / rounds)
            if per:
                table = {k: sorted(v)[len(v) // 2] for k, v in sorted(per.items())}
                print(f"{label} " + json.dumps({"tree": result["tree"], "us": table}), flush=True)
    # with --tiles: the bf16 resident instance's table, per (nb1, nb2) m64 row
    # blocks of stage 1 and of the 3x3 (ops/bottleneck._bf16_blocks), the median
    # of tile_us over the 96->48->96 and 48->48->96 shapes of more than one
    # round of two tiles per SM, tree by tree
    for result in results:
        per = {}
        for r in result["rows"]:
            if r["kernel"] != "bottleneck_bf16" or r["channels"][1] != 48:
                continue
            for tile, us in r.get("tile_us", {}).items():
                t_h, t_w = map(int, tile.split("x"))
                if r["tile_rounds"][tile] > 1:
                    key = f"{-(-(t_h + 2) * (t_w + 2) // 64)},{-(-t_h * (t_w + 2) // 64)}"
                    per.setdefault(key, []).append(us)
        if per:
            table = {k: sorted(v)[len(v) // 2] for k, v in sorted(per.items())}
            print("BF16_TILE_TABLE " + json.dumps({"tree": result["tree"], "us": table}),
                  flush=True)
    print("COMPARE " + json.dumps({"shapes": len(outputs), "trees": args.trees,
                                   "equal": sorted(set(outputs) - set(differ)),
                                   "differ": differ}), flush=True)
    if differ and not args.no_check:
        raise SystemExit(f"outputs differ across trees at {sorted(differ)}")


if __name__ == "__main__":
    main()
