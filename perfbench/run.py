"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds the program's CUDA kernels
where they are not built yet (into the checkout), decodes the traffic
mix's frame source, makes the cell's chunk pool and weights from the seed,
builds the program of the mix's entry (``entries/<entry>.py``: the 2D->3D
``Pipeline``, or the CLI's ``PoseEstimator`` ingest) and warms the cell's
one shape.  The window calls the program on the pool's chunks round robin,
one client in a closed loop, each call's outputs copied to the host before
the next call, for ``--seconds``.  Then the program is freed, the entry's
plain reference (``reference/``) computes every chunk, and every call's
outputs are judged against it by the entry's judge.  With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics instead of
the end-to-end ones.

The last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error.  Without a card, with fewer
cards than the cell asks for, or when JAX was loaded, the run prints no
result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# every cache a run could write, inside the checkout at fixed paths, before torch loads
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)

import numpy as np  # noqa: E402

import harness  # noqa: E402


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def end_to_end(cell, w, setup_s: float, peak_bytes: int) -> dict:
    calls = len(w.times)
    values = {
        "frames_per_s": cell.mix["T"] * calls / w.seconds,
        "call_ms_p95": float(np.percentile(np.asarray(w.times), 95)) * 1e3,
        "peak_mem_gib": peak_bytes / 2 ** 30,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell, w, notes: list):
    import devtrace
    import progspans

    tr = devtrace.reduce(w.prof)
    w0, w1 = tr.window
    ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, T=cell.mix["T"], trace=tr,
                          window_s=(w1 - w0) * 1e-9)
    out = {}
    for m in cell.per_layer:
        got = harness.metric_reader(m["name"])(ctx)
        if isinstance(got, tuple):
            got, note = got
            notes.append(f"{m['name']}: {note}")
        if got is not None:
            out[m["name"]] = {"value": got, "unit": m["unit"]}
    notes.append("device ranges that are not work: " + json.dumps(tr.dropped))
    device = {"busy_s": devtrace.busy_ns(tr.kernels + tr.copies) * 1e-9,
              "window_s": (w1 - w0) * 1e-9}
    return out, device, devtrace.breakdown(tr, progspans.idle_by_span(progspans.of(ctx), tr))


def run_cell(cell, seed: int, seconds: float, traced: bool, device, root: str = ROOT,
             break_program=None):
    """One run; -> (the result object, the lines of numbers compared).
    ``break_program(program)``, for the harness's own tests, may replace the
    program by a faulty one before the window."""
    import torch

    entry = cell.entry
    s = harness.setup(cell, seed, device, root)
    if break_program is not None:
        s.prog = break_program(s.prog)
    harness.warm_up(s)
    setup_s = harness.process_age_s()
    stages = {"before_setup": setup_s - sum(s.stages.values()), **s.stages}
    w = harness.window(s, seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    golden = entry.golden(cell, s, root)
    if golden is not None:
        print("golden contract (informational): " + json.dumps(golden), flush=True)
    notes = ["set-up seconds: " + json.dumps(stages)]
    metrics = end_to_end(cell, w, setup_s, peak) if not traced else None
    dev_extra, breakdown = {}, None
    if traced:
        metrics, dev_extra, breakdown = per_layer(cell, w, notes)
    w.prof = None
    kept = entry.keep(s.prog)
    s.prog = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs = entry.reference(cell, s.pool, s.made, device, root)
    got = harness.judge(cell, w.outputs, w.chunk_of, refs)
    checks = {n: {"value": _finite(got[n]), "limit": cell.limits[n]} for n in entry.NAMES}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {
        "correct": got["correct"],
        "attempted": len(w.times),
        "failed": got["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
                   "count": cell.chips, "memory_peak_bytes": int(peak), **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = notes + entry.notes(got, kept, refs)
    lines += [f"check {n}: {c['value']!r} limit {c['limit']!r}" for n, c in checks.items()]
    return result, lines


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {_card_line()}", file=sys.stderr, flush=True)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
