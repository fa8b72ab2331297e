#!/usr/bin/env python3
"""Where one launch of the bottleneck kernel's general instance spends its time, by stage, on one CUDA card.

    python3 scripts/profile_general_stages.py
    python3 scripts/profile_general_stages.py --zero-skip   # and without the identity skip's loads

Builds an instrumented copy of ``deepfly3d_torch/ops/csrc/bottleneck_general.cu``
in a temporary folder: one consumer thread of each thread block (the first
lane of the first consumer warpgroup) reads ``clock64`` at the edges of each
stage's k-chunk loop (``loopN``), of each pass's epilogue (``epiN``) and of
the named barrier after the stage (``syncN``), and adds the cycles between
them per thread block.  The copy replaces the library the wrapper loads; each
shape of the converted 256-wide path (the raw projecting stem block at
56x128x256, a 256->128->256 block at 56x64x128 and at 56x8x16) is checked
against the plain version and launched once, and the script prints the
launch's ms (CUDA events), the cycles per thread block and each part's share.
``--zero-skip`` also times a copy whose identity skip adds zeros instead
of x (its outputs are wrong by design; only its time is reported): the cost
of the epilogue's loads of x.  The card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "deepfly3d_torch", "ops", "csrc", "bottleneck_general.cu")
NAMES = ["loop1", "epi1", "sync1", "loop2", "epi2", "sync2", "loop3", "epi3", "sync3", "tile"]
SHAPES = [(56, 128, 256, 128, 128, 256, True, True), (56, 64, 128, 256, 128, 256, False, False),
          (56, 8, 16, 256, 128, 256, False, False)]

PROBE = """namespace {
__device__ unsigned long long df3d_prof[1024 * 16];
__device__ long long df3d_last[1024];
__device__ __forceinline__ void prof(int k) {
  if (threadIdx.x == 128) {
    const long long now = clock64();
    if (k >= 0) df3d_prof[blockIdx.x * 16 + k] += now - df3d_last[blockIdx.x];
    df3d_last[blockIdx.x] = now;
  }
}
"""
READ = """int df3d_prof_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, df3d_prof, sizeof(df3d_prof));
}
int df3d_prof_zero() {
  static unsigned long long zero[1024 * 16];
  return (int)cudaMemcpyToSymbol(df3d_prof, zero, sizeof(zero));
}
}  // extern "C\""""
# (a line of the kernel's tile loop, the mark that follows it); the first
# stage's call is marked before it as well
MARKS = [("consume<T, 1,", 1), ("// a2 is complete", 2), ("consume<T, 2,", 4),
         ("// a3 is complete", 5), ("else consume<T, 3,", 7), ("// a2 and a3 are free", 8)]
SKIP_LOAD = "res[i][h] = load_pair(xrow(b, h), col, L.cin);"


def instrument(src: str, skip_loads: bool) -> str:
    """The source with the clock64 marks (and, with ``skip_loads``, an identity
    skip of zeros); raises if the source no longer has the anchors."""
    subs = [
        ("namespace {\n", PROBE),
        ("    for (int mp = 0; mp < P.mp; ++mp) {\n      // this warpgroup's rows",
         "    for (int mp = 0; mp < P.mp; ++mp) {\n      prof(3 * (S - 1) + 1);\n"
         "      // this warpgroup's rows"),
        ("      // stage 2 writes a3 over a2", "      prof(3 * (S - 1));\n      // stage 2 writes a3 over a2"),
        ("  Ctx<T> c;\n", "  prof(-1);\n  Ctx<T> c;\n"),
        ('}  // extern "C"', READ),
    ]
    lines = src.split("\n")
    for key, mark in MARKS:
        at = [i for i, line in enumerate(lines) if key in line]
        if len(at) != 1:
            raise SystemExit(f"profile_general_stages: line {key!r} not found once in the source")
        indent = lines[at[0]][:len(lines[at[0]]) - len(lines[at[0]].lstrip())]
        lines.insert(at[0] + 1, f"{indent}prof({mark});")
        if mark == 1:
            lines.insert(at[0], f"{indent}prof(9);")
    src = "\n".join(lines)
    if skip_loads:
        subs.append((SKIP_LOAD, "res[i][h] = make_float2(0.f, 0.f);"))
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"profile_general_stages: anchor not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--zero-skip", action="store_true",
                    help="also time a copy whose identity skip adds zeros")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_general_stages: needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deepfly3d_torch.ops import _build
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.utils.devices import full_f32

    full_f32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with open(SOURCE) as fh:
        src = fh.read()
    copies = {"marked": False} | ({"marked_zero_skip": True} if args.zero_skip else {})
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, skip in copies.items():
            cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, f"lib{name}.so")
            with open(cu, "w") as fh:
                fh.write(instrument(src, skip))
            built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                                    "-o", so, cu],
                                   capture_output=True, text=True)
            if built.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{built.stdout}{built.stderr}")
            libs[name] = ctypes.CDLL(so)
        for name, lib in libs.items():
            _build._loaded["bottleneck_general"] = lib
            _build.entry.cache_clear()
            for key in SHAPES:
                n, h, w, cin, cmid, cout, proj, raw = key
                params, stats = chip_smoke.seeded_block(np, cin, cmid, cout)
                if not proj:
                    params.pop("proj")
                for dtype in ("float32", "bfloat16"):
                    f = {k: v.to(dev) for k, v in bn.add_packed(
                        bn.fold_bottleneck(params, stats, raw, dtype)).items()}
                    x = torch.randn((n, h, w, cin), generator=torch.Generator().manual_seed(6))
                    x = x.to(dev).to(getattr(torch, dtype))
                    y = bn.fused_bottleneck(x, f)
                    ref = bn.bottleneck_plain(x, f).float()
                    err = (y.float() - ref).abs().max().item()
                    mag = ref.abs().max().item()
                    tol = (5e-5 * max(1.0, mag) if dtype == "float32"
                           else 2 * 2.0 ** (np.floor(np.log2(mag)) - 7))
                    if name == "marked" and not err <= tol:
                        raise AssertionError(f"{dtype} {key}: err {err} > {tol}")
                    lib.df3d_prof_zero()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    bn.fused_bottleneck(x, f)
                    end.record()
                    end.synchronize()
                    buf = np.zeros(1024 * 16, np.uint64)
                    lib.df3d_prof_read(ctypes.c_void_p(buf.ctypes.data))
                    th, tw = bn.choose_tile(n, h, w, cin, cmid, cout, proj, dtype)
                    blocks = min(n * -(-h // th) * -(-w // tw), bn.NUM_SMS)
                    per = buf.reshape(1024, 16)[:blocks, :10].astype(np.float64).mean(0)
                    total = per.sum()
                    print(f"STAGES {name} {dtype} {list(key[:6])} {start.elapsed_time(end):.4f} ms, "
                          f"{total:.0f} cycles per thread block: " + " ".join(
                              f"{k}={v / total:.3f}" for k, v in zip(NAMES, per)), flush=True)
        _build.entry.cache_clear()
        _build._loaded.pop("bottleneck_general", None)


if __name__ == "__main__":
    main()
