#!/usr/bin/env python3
"""Sweep the tile height of the bottleneck kernel's general instance on one CUDA card.

    python3 scripts/sweep_general_tiles.py            # float32 and bf16
    python3 scripts/sweep_general_tiles.py --quick    # fewer repeats

For each shape of the converter's default 256-wide network at N=56 (the
raw projecting stem block at 128x256, the 256->128->256 blocks from 64x128
down to 8x16) and the README toy trainer's 16->8->16 block, every tile
height th (tiles of th x 16 pixels, at most ``GENERAL_TILE_PIXELS`` of the dtype) that
fits one thread block's shared memory is launched through
``ops/bottleneck.fused_bottleneck`` with ``choose_tile`` pinned to it,
checked against the plain version (float32 within 5e-5 of the output's
magnitude, bf16 within 2 bf16 ulps), and timed as device time from a
replayed CUDA graph.  Per row: the launch's ms, its waves of thread blocks
over the SMs, and ``us_per_tile`` = launch time / waves, the quantity
``ops/bottleneck._TILE_US_GENERAL`` (float32) and ``_TILE_US_GENERAL_BF16``
tabulate per 16-pixel row tiles (a wave: one tile per SM of the kernel's
persistent thread blocks).  The card's name and power limit first; one JSON
line per row, prefixed ``ROW``; last, ``TABLE``: per row-tile count, the
median of ``us_per_tile`` over the float32 shapes that launch more than one
wave (the first table's figures) and over the bf16 ones (the second's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (N, H, W, Cin, Cmid, Cout, projection, raw)
SHAPES = [(56, 128, 256, 128, 128, 256, True, True), (56, 64, 128, 256, 128, 256, False, False),
          (56, 32, 64, 256, 128, 256, False, False), (56, 16, 32, 256, 128, 256, False, False),
          (56, 8, 16, 256, 128, 256, False, False), (105, 16, 32, 16, 8, 16, False, False)]


def graph_ms(torch, fn, iters, replays):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_general_tiles: needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deepfly3d_torch.ops import _build
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.utils.devices import full_f32

    full_f32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    _build.build()
    dev = torch.device("cuda", 0)
    iters, replays = (3, 2) if args.quick else (5, 4)
    chosen = bn.choose_tile
    rows = []
    try:
        for key in SHAPES:
            n, h, w, cin, cmid, cout, proj, raw = key
            params, stats = chip_smoke.seeded_block(np, cin, cmid, cout)
            if not proj:
                params.pop("proj")
            for dtype in ("float32", "bfloat16"):
                f = {k: v.to(dev) for k, v in bn.add_packed(
                    bn.fold_bottleneck(params, stats, raw, dtype)).items()}
                x = torch.randn((n, h, w, cin), generator=torch.Generator().manual_seed(0))
                x = x.to(dev).to(getattr(torch, dtype))
                ref = bn.bottleneck_plain(x, f).float()
                tw = min(bn.TILE_MAX_WIDTH, w)
                for th in range(1, min(h, bn.GENERAL_TILE_PIXELS[dtype] // tw) + 1):
                    if bn.smem_bytes(cin, cmid, cout, th, tw, proj, dtype) > bn.MAX_SMEM:
                        break
                    bn.choose_tile = lambda *a, th=th, tw=tw: (th, tw)
                    err = (bn.fused_bottleneck(x, f).float() - ref).abs().max().item()
                    mag = ref.abs().max().item()
                    tol = (chip_smoke.BLOCK_TOL * max(1.0, mag) if dtype == "float32"
                           else 2 * 2.0 ** (np.floor(np.log2(mag)) - 7))
                    if not err <= tol:
                        raise AssertionError(f"{dtype} {key} tile {(th, tw)}: err {err} > {tol}")
                    ms = graph_ms(torch, lambda: bn.fused_bottleneck(x, f), iters, replays)
                    blocks = n * -(-h // th) * -(-w // tw)
                    waves = -(-blocks // bn.NUM_SMS)
                    rows.append({"shape": list(key[:6]), "proj": proj, "raw": raw,
                                 "dtype": dtype, "tile": [th, tw], "ms": ms, "blocks": blocks,
                                 "waves": waves, "us_per_tile": 1e3 * ms / waves,
                                 "row_tiles": -(-th * tw // 16), "chosen": chosen(
                                     n, h, w, cin, cmid, cout, proj, dtype) == (th, tw)})
                    print("ROW " + json.dumps(rows[-1]), flush=True)
                torch.cuda.empty_cache()
    finally:
        bn.choose_tile = chosen
    table = {}
    for dtype in ("float32", "bfloat16"):
        per = {}
        for r in rows:
            if r["dtype"] == dtype and r["waves"] > 1:
                per.setdefault(r["row_tiles"], []).append(r["us_per_tile"])
        table[dtype] = {m: float(np.median(v)) for m, v in sorted(per.items())}
    print("TABLE " + json.dumps(table))


if __name__ == "__main__":
    main()
