#!/usr/bin/env python3
"""Drive the PyTorch port's golden 2D->3D path on one CUDA card.

    python3 chip_smoke.py              # from the root of a checkout

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. the card's name and power limit, torch and CUDA versions;
2. build the three CUDA kernels from ``deepfly3d_torch/ops/csrc``;
3. kernel phase: every kernel against its plain PyTorch version on the
   card, at every shape the main path gives it, with the tolerance stated;
   kernel, plain and one-library-call times by CUDA events; the least time
   the card could take (``bound_ms``) from the shapes;
4. slice phase: ``build_pipeline(device="cuda")`` at full width (the
   shipped 2-stack f96 checkpoint, T=8 frames = 56 images of 480x960, rig
   on), launch counts read around that one run (31 bottlenecks, 8
   upsample-adds, 1 decode per forward), its output against the same
   pipeline with plain versions on the card, and frames/s (informational);
5. golden phase: frame 0 of the golden recording against the JAX package's
   output on it (``deepfly3d_torch/data/golden_t0.npz``) and against the
   golden pickle.

Then one JSON line with every kernel's numbers and, last, the device line.
``--profile FILE`` also writes a torch.profiler table of one pipeline call
to FILE.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BATCH_T = 8                      # frames of 7 cameras in the slice phase

# bottleneck shapes of one forward at N images: (block whose weights are
# used, H, W, Cin, launches per forward)
BLOCK_SHAPES = [
    ("stem_res1", 128, 256, 48, 1),
    ("stem_res2", 64, 128, 96, 6),
    ("hg0/down_d4_0", 32, 64, 96, 6),
    ("hg0/down_d3_0", 16, 32, 96, 6),
    ("hg0/down_d2_0", 8, 16, 96, 6),
    ("hg0/down_d1_0", 4, 8, 96, 6),
]
MERGE_SHAPES = [(4, 8), (8, 16), (16, 32), (32, 64)]   # inner (H, W), 2 per forward
BLOCK_TOL = 5e-5        # of the output's largest magnitude: f32 sums reordered


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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main(argv):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "deepfly3d_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from deepfly3d_torch.config import fly_config
    from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.ops import _build, geometry
    from deepfly3d_torch.ops import bottleneck as bn
    from deepfly3d_torch.ops import kernels
    from deepfly3d_torch.pipeline import build_pipeline
    from deepfly3d_torch.utils.devices import full_f32

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    full_f32()
    card = gpu_name_and_limit()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = fly_config()
    num_cameras, input_hw = cfg.num_cameras, cfg.network.input_shape
    variables, spec = load_weights(cfg.network.checkpoint)
    folded = fold_hourglass(variables, spec)
    blocks = {name: {k: v.to(dev) for k, v in t.items()}
              for name, t in folded["blocks"].items()}
    N = BATCH_T * num_cameras
    gen = torch.Generator().manual_seed(0)

    # ---- 3. kernel phase
    shape_rows = []
    per_kernel = {}

    def record(kernel, row, count):
        shape_rows.append({"kernel": kernel, **row, "per_forward": count})
        agg = per_kernel.setdefault(kernel, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                             "library_ms": 0.0, "bound_ms": 0.0,
                                             "flops": 0.0, "bytes": 0.0})
        agg["max_abs_err"] = max(agg["max_abs_err"], row["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            agg[key] += count * row[key]
        agg["flops"] += count * row["flops"]
        agg["bytes"] += count * row["bytes"]

    def oihw(w2d):
        return w2d.t().contiguous()[:, :, None, None]

    for name, h, w, cin, count in BLOCK_SHAPES:
        f = blocks[name]
        cmid, cout = f["w1"].shape[1], f["w3"].shape[1]
        proj = "wp" in f
        x = torch.randn((N, h, w, cin), generator=gen).to(dev)
        y = bn.fused_bottleneck(x, f)
        ref = bn.bottleneck_plain(x, f)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        if not err <= BLOCK_TOL * scale:
            raise AssertionError(f"bottleneck {name} {tuple(x.shape)}: max abs err {err} "
                                 f"> {BLOCK_TOL} x {scale}")
        lw = {"w1": oihw(f["w1"]), "w3": oihw(f["w3"]),
              "w2": f["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1).contiguous()}
        if proj:
            lw["wp"] = oihw(f["wp"])

        def library(x=x, f=f, lw=lw, proj=proj):
            xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW view
            a1 = torch.relu(xc * f["s1"].view(1, -1, 1, 1) + f["t1"].view(1, -1, 1, 1))
            a2 = torch.relu(F.conv2d(a1, lw["w1"], f["b1"][0]))
            a3 = torch.relu(F.conv2d(a2, lw["w2"], f["b2"][0], padding=1))
            z = F.conv2d(a3, lw["w3"], f["b3"][0])
            return z + (F.conv2d(a1, lw["wp"], f["bp"][0]) if proj else xc)

        lib_err = (library().permute(0, 2, 3, 1) - ref).abs().max().item()
        flops = 2.0 * N * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                                   + (cin * cout if proj else 0))
        nbytes = 4.0 * (N * h * w * (cin + cout) + sum(t.numel() for t in f.values()))
        b_ms, b_by = bound_ms(flops, nbytes)
        row = {"name": name, "shape": [N, h, w, cin, cmid, cout], "max_abs_err": err,
               "library_err": lib_err,
               "ms": cuda_ms(torch, lambda: bn.fused_bottleneck(x, f)),
               "plain_ms": cuda_ms(torch, lambda: bn.bottleneck_plain(x, f)),
               "library_ms": cuda_ms(torch, library),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
        record("fused_bottleneck", row, count)
        del x, y, ref

    for h, w in MERGE_SHAPES:
        inner = torch.randn((N, h, w, 96), generator=gen).to(dev)
        skip = torch.randn((N, 2 * h, 2 * w, 96), generator=gen).to(dev)
        out = kernels.upsample2x_add(inner, skip)
        ref = kernels.upsample2x_add_plain(inner, skip)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"upsample2x_add {tuple(inner.shape)}: max abs err {err} != 0")
        nbytes = 4.0 * (inner.numel() + 2 * skip.numel())
        b_ms, b_by = bound_ms(float(skip.numel()), nbytes)

        def library(inner=inner, skip=skip):
            return skip + inner.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        row = {"name": "merge", "shape": list(inner.shape), "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: kernels.upsample2x_add(inner, skip)),
               "plain_ms": cuda_ms(torch, lambda: kernels.upsample2x_add_plain(inner, skip)),
               "library_ms": cuda_ms(torch, library),
               "bound_ms": b_ms, "bound_by": b_by, "flops": float(skip.numel()),
               "bytes": nbytes}
        record("upsample2x_add", row, 2)

    hm = torch.randn((N, 64, 128, 19), generator=gen)
    hm[0, :, :, 0] = 1.0                                  # planted ties
    hm[1, 3, 4, 2] = hm[1, 50, 60, 2] = 7.0
    hm = hm.to(dev)
    pts, conf = kernels.decode_heatmaps(hm)
    ref_pts, ref_conf = kernels.decode_heatmaps_plain(hm)
    torch.cuda.synchronize()
    err = max((pts - ref_pts).abs().max().item(), (conf - ref_conf).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"decode {tuple(hm.shape)}: max abs err {err} != 0")
    nbytes = 4.0 * (hm.numel() + pts.numel() + conf.numel())
    b_ms, b_by = bound_ms(float(hm.numel()), nbytes)
    hm_flat = hm.view(N, 64 * 128, 19)
    row = {"name": "decode", "shape": list(hm.shape), "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: kernels.decode_heatmaps(hm)),
           "plain_ms": cuda_ms(torch, lambda: kernels.decode_heatmaps_plain(hm)),
           "library_ms": cuda_ms(torch, lambda: torch.max(hm_flat, dim=1)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": float(hm.numel()), "bytes": nbytes}
    record("decode_heatmaps", row, 1)
    del hm, hm_flat
    print(json.dumps({"kernel_shapes": shape_rows}))

    # ---- 4. slice phase, full width
    with np.load(os.path.join(ROOT, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        ref0 = {k: z[k] for k in z.files}
    order = ref0["camera_ordering"]
    with open(cfg.calib_prior_path, "rb") as fh:
        calib = geometry.calib_to_arrays(pickle.load(fh), num_cameras, dtype=np.float32)
    rng = np.random.default_rng(0)
    noise = rng.integers(-3, 4, size=(BATCH_T,) + ref0["frames"].shape, dtype=np.int16)
    frames_np = np.clip(ref0["frames"][None].astype(np.int16) + noise, 0, 255).astype(np.uint8)
    frames = torch.from_numpy(frames_np).to(dev)

    pipe = build_pipeline(spec, variables, calib, order, input_hw, rig="auto", device=dev)
    counters = (bn.fused_bottleneck, kernels.upsample2x_add, kernels.decode_heatmaps)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    pts3d, p38, conf = pipe(frames)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {"fused_bottleneck": 31, "upsample2x_add": 8, "decode_heatmaps": 1}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    print(f"slice launches: {launches}")
    if not (torch.isfinite(pts3d).all() and pts3d.shape == (BATCH_T, 38, 3)
            and p38.shape == (num_cameras, BATCH_T, 38, 2)
            and conf.shape == (num_cameras, BATCH_T, 19, 1)):
        raise AssertionError("slice outputs have the wrong shape or are not finite")

    class PlainHourglass(FoldedHourglass):
        def block(self, name, x):
            return bn.bottleneck_plain(x, self.blocks[name].as_dict())

        def merge(self, inner, skip):
            return kernels.upsample2x_add_plain(inner, skip)

    plain = build_pipeline(spec, variables, calib, order, input_hw, rig="auto", device=dev)
    plain.net = PlainHourglass(folded, spec).to(dev).eval()
    plain.decode = kernels.decode_heatmaps_plain
    before = [c.launches for c in counters]
    q3d, q38, qconf = plain(frames)
    torch.cuda.synchronize()
    if [c.launches for c in counters] != before:
        raise AssertionError("the plain pipeline launched a kernel")
    if not torch.equal(p38, q38):
        n_diff = int((p38 != q38).any(-1).sum().item())
        raise AssertionError(f"slice p38 differs from the plain pipeline at {n_diff} points")
    conf_diff = (conf - qconf).abs().max().item()
    pts3d_diff = ((pts3d - q3d).abs().max() / q3d.abs().max().clamp_min(1e-30)).item()
    if conf_diff > 1e-4 or pts3d_diff > 1e-5:
        raise AssertionError(f"slice vs plain: conf {conf_diff}, points3d rel {pts3d_diff}")
    print(f"slice vs plain on the card: p38 equal, conf max diff {conf_diff}, "
          f"points3d max rel diff {pts3d_diff}")

    def fps(p, iters=5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            p(frames)
        torch.cuda.synchronize()
        return BATCH_T * iters / (time.perf_counter() - t)

    pipe(frames), plain(frames)                    # warm both
    turns = [(fps(pipe), fps(plain)) for _ in range(2)]   # kernel, plain, kernel, plain
    kernel_fps = [k for k, _ in turns]
    plain_fps = [q for _, q in turns]
    print(f"informational: frames/s in turns (7-camera frames, T={BATCH_T}, frames already "
          f"on the card): kernels {kernel_fps}, plain versions {plain_fps}, on {card}")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        profile_path = argv[argv.index("--profile") + 1]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe(frames)
            torch.cuda.synchronize()
        with open(profile_path, "w") as fh:
            fh.write(card + "\n")
            fh.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))

    # ---- 5. golden phase
    with open(os.path.join(ROOT, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"),
              "rb") as fh:
        golden = pickle.load(fh)
    pipe0 = build_pipeline(spec, variables, calib, order, input_hw, rig=None, device=dev)
    _, g38, gconf = pipe0(ref0["frames"][None])
    g38, gconf = g38.cpu().numpy(), gconf.cpu().numpy()
    if not np.array_equal(g38, ref0["p38"]):
        raise AssertionError("golden frame: p38 differs from the JAX package's")
    conf_vs_jax = float(np.abs(gconf - ref0["conf"]).max())
    pts_err = float(np.abs(g38 - golden["points2d"][:, :1]).max())
    conf_err = float(np.abs(gconf - golden["heatmap_confidence"][:, :1]).max())
    if conf_vs_jax > 2e-5 or pts_err > 0.02 or conf_err > 0.002:
        raise AssertionError(f"golden frame: conf vs JAX {conf_vs_jax}, pts_err {pts_err}, "
                             f"conf_err {conf_err}")
    print(f"golden frame 0: p38 equal to JAX, conf vs JAX {conf_vs_jax} (<= 2e-5), "
          f"pts_err {pts_err} (<= 0.02), conf_err {conf_err} (band 0.002)")

    sources = {
        "fused_bottleneck": ("deepfly3d_torch/ops/csrc/bottleneck.cu",
                             "deepfly3d_tpu/ops/pallas/bottleneck.py:433",
                             ["deepfly3d_tpu/ops/pallas/bottleneck.py:359",
                              "deepfly3d_tpu/ops/pallas/bottleneck.py:486"]),
        "upsample2x_add": ("deepfly3d_torch/ops/csrc/upsample_add.cu",
                           "deepfly3d_tpu/ops/pallas/kernels.py:49", []),
        "decode_heatmaps": ("deepfly3d_torch/ops/csrc/decode.cu",
                            "deepfly3d_tpu/ops/pallas/kernels.py:97", []),
    }
    entries = []
    for name, (src, replaces, also) in sources.items():
        agg = per_kernel[name]
        _, b_by = bound_ms(agg["flops"], agg["bytes"])
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "also_replaces": also, "launches": launches[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"], "bound_by": b_by,
            "library_ms": agg["library_ms"],
            "per": f"one forward at N={N} ({BATCH_T} frames x {num_cameras} cameras)",
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
