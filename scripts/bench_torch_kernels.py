#!/usr/bin/env python3
"""Time the port's bottleneck, decode and preprocess kernels, one or several checkouts in turns.

    python3 scripts/bench_torch_kernels.py                       # this checkout
    python3 scripts/bench_torch_kernels.py --trees OLD . . OLD   # two checkouts, in turns
    python3 scripts/bench_torch_kernels.py --quick               # one launch per shape, no timing
    python3 scripts/bench_torch_kernels.py --match 56x480x960x256x512 --stage-rows 4,8,12

Needs one CUDA card.  Each tree runs in its own process (each builds its own
kernels with nvcc): every shape below goes through the tree's
``fused_bottleneck`` / ``decode_heatmaps`` / ``preprocess_resize`` wrapper, is
compared with the tree's plain version (and, where the tree has one, with the
bottleneck's TF32 arithmetic model), and is timed twice: ``ms`` by CUDA events
around eager calls (the wrapper's host work included, which decides at small
shapes) and ``device_ms`` from a replayed CUDA graph of 20 calls (device time
alone).  The preprocess is timed at the signature every tree has (no shift,
no gain); where the tree's wrapper takes the rig registration's ``shift``
and ``gain``, those are timed as well (``fused_device_ms``), beside the
composition they replace (``unfused_device_ms``: ``apply_shift_tc``'s
gathers, the kernel, the gain multiply), and the fused result must equal
that composition bit for bit.  ``--stage-rows`` times the preprocess at
other budgets of staged input rows, and so other band heights (trees with
``kernels.preprocess_plan``).  One JSON line per
tree, prefixed ``RESULT``; the card's name and power limit first.  Comparing
two versions is only meaningful inside one call, on one card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

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
DECODE_SHAPES = [(56, 64, 128, 19), (56, 48, 96, 19), (7, 64, 128, 19), (5, 7, 9, 19),
                 (3, 16, 32, 6)]
# (N, H, W, h, w): the conv and p16 paths, the cascade's student and teacher,
# identity mode (the TPU kernel's function; on no path) and rows of 150 bytes
PREPROCESS_SHAPES = [(56, 480, 960, 256, 512), (56, 480, 960, 192, 384), (7, 480, 960, 256, 512),
                     (56, 480, 960, 480, 960), (3, 37, 50, 13, 29)]
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


def preprocess_rows(torch, kernels, image_ops, shape, dev, gen, quick, no_check, budget):
    """Check and time one preprocess shape; -> the result row."""
    n, h_in, w_in, h, w = shape
    x = torch.randint(0, 256, (n, h_in, w_in, 3), generator=gen, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 3 == 1).to(dev)
    iters = 1 if quick else 20
    identity = (h, w) == (h_in, w_in)
    row = {"kernel": "preprocess", "shape": list(shape),
           "bound_ms": (x.numel() + 4 * n * h * w * 3) / PEAK_BYTES * 1e3}
    if budget:
        row["plan"] = list(kernels.preprocess_plan(h_in, w_in, 3, h, w, budget))
    out = kernels.preprocess_resize(x, flip, (h, w))
    torch.cuda.synchronize()
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
    if "shift" in inspect.signature(kernels.preprocess_resize).parameters:
        from deepfly3d_torch.ops import canonicalize

        dy = torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
        dx = torch.randint(-8, 9, (n,), generator=gen, dtype=torch.int32).to(dev)
        gain = (0.9 + 0.2 * torch.rand(n, generator=gen)).to(dev)
        gain[::4] = 1.0

        def fused():
            return kernels.preprocess_resize(x, flip, (h, w), shift=(dy, dx), gain=gain)

        def unfused():
            rolled = canonicalize.apply_shift_tc(x[None], dy, dx)[0]
            return kernels.preprocess_resize(rolled, flip, (h, w)) * gain[:, None, None, None]

        row["fused_equal"] = torch.equal(fused(), unfused())
        if not no_check and not row["fused_equal"]:
            raise AssertionError(f"preprocess {row}: fused != unfused composition")
        if not quick:
            row["fused_device_ms"] = graph_ms(torch, fused)
            row["unfused_device_ms"] = graph_ms(torch, unfused)
    return row


def run_tree(root, quick, no_check=False, match=None, budgets=None):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepfly3d_torch.config import WEIGHTS_DIR
    from deepfly3d_torch.models.fused_inference import fold_hourglass
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.ops import _build, kernels
    from deepfly3d_torch.ops import image as image_ops
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.utils.devices import full_f32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    full_f32()
    dev = torch.device("cuda", 0)
    for name, log in _build.build().items():
        for line in log.splitlines():
            if any(word in line for word in ("registers", "spill", "error", "warning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    blocks = fold_hourglass(*load_weights(os.path.join(WEIGHTS_DIR, "hourglass_fly.npz")))["blocks"]
    pack = getattr(bn, "add_packed", lambda f: f)
    model = getattr(bn, "bottleneck_tf32_model", None)
    gen = torch.Generator().manual_seed(0)
    iters = 1 if quick else 20
    rows = []
    picked = lambda *shape: match is None or "x".join(map(str, shape)) in match
    for n, h, w, name in BLOCK_SHAPES:
        if not picked(n, h, w):
            continue
        f = {k: v.to(dev) for k, v in pack(blocks[name]).items()}
        x = torch.randn((n, h, w, f["w1"].shape[0]), generator=gen).to(dev)
        y = bn.fused_bottleneck(x, f)
        torch.cuda.synchronize()
        ref = bn.bottleneck_plain(x, f)
        row = {"kernel": "bottleneck", "shape": [n, h, w], "block": name,
               "scale": ref.abs().max().item(), "err_plain": (y - ref).abs().max().item()}
        if model is not None:
            row["err_model"] = (y - model(x, f)).abs().max().item()
        if not no_check and not row["err_plain"] <= 5e-5 * max(1.0, row["scale"]):
            raise AssertionError(f"bottleneck {row}")
        if not quick:
            row["ms"] = cuda_ms(torch, lambda: bn.fused_bottleneck(x, f), iters)
            row["device_ms"] = graph_ms(torch, lambda: bn.fused_bottleneck(x, f))
            row["plain_ms"] = cuda_ms(torch, lambda: bn.bottleneck_plain(x, f), iters)
        rows.append(row)
        print(row, flush=True)
        del x, y, ref
        torch.cuda.empty_cache()
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
    for shape in PREPROCESS_SHAPES:
        if not picked(*shape):
            continue
        for budget in (budgets if budgets and default else [default]):
            kernels.PREPROCESS_STAGE_ROWS = budget
            rows.append(preprocess_rows(torch, kernels, image_ops, shape, dev, gen, quick,
                                        no_check, budget))
            print(rows[-1], flush=True)
            torch.cuda.empty_cache()
        kernels.PREPROCESS_STAGE_ROWS = default
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
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_tree(args.one, args.quick, args.no_check,
                        args.match.split(",") if args.match else None,
                        [int(r) for r in args.stage_rows.split(",")] if args.stage_rows else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        cmd += (["--quick"] if args.quick else []) + (["--no-check"] if args.no_check else [])
        cmd += ["--match", args.match] if args.match else []
        cmd += ["--stage-rows", args.stage_rows] if args.stage_rows else []
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
