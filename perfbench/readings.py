"""The readings that the limits of ``limits/<config>.json`` are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--out FILE]

For each seed, in one process: the cell's set-up (pool, weights, the
program's pipeline), one call of the program on every chunk of the pool,
and then, with the program freed, the reference on every chunk and the
numbers of ``compare.py`` (the program's lower readings).  The same calls
are judged with faults planted in their outputs: the previous chunk's
outputs returned (a call that hands back stale state), half of the frames
computed and the rest copied from them, one 2D point moved one cell, one
frame's 3D points moved by 1%, and one frame's 3D points zeroed.  For each
control seed, the reference itself, computed with TF32 on, stands in the
program's place (the control: the nearest precision below the
configuration's float32).  One JSON line
per seed and kind.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


import compare  # noqa: E402
import harness  # noqa: E402


def _numbers(cell, outs, chunk_of, results, rig):
    got = harness.judge(cell, outs, chunk_of, results, rig)
    return {n: got[n] for n in compare.NAMES + ("mismatched", "correct")}


def _faults(cell, s, outs):
    """{fault: the outputs of one call per chunk with that fault planted}."""
    import torch

    n = len(outs)
    stale = [outs[(k - 1) % n] for k in range(n)]
    half = []
    for chunk in s.pool:
        T = chunk.shape[0]
        p3d, p38, conf = (t.cpu() for t in s.pipe(chunk[: T // 2]))
        half.append((torch.cat([p3d, p3d], 0)[:T], torch.cat([p38, p38], 1)[:, :T],
                     torch.cat([conf, conf], 1)[:, :T]))
    cam = int(cell.cfg["camera_ordering"][0])         # a left camera: joint 0 carries a cell
    moved2d, moved3d, zeroed3d = [], [], []
    for p3d, p38, conf in outs:
        p38_moved, p3d_moved, p3d_zeroed = p38.clone(), p3d.clone(), p3d.clone()
        p38_moved[cam, 0, 0, 0] += 1.0 / 64
        p3d_moved[0] *= 1.01
        p3d_zeroed[0] = 0.0
        moved2d.append((p3d, p38_moved, conf))
        moved3d.append((p3d_moved, p38, conf))
        zeroed3d.append((p3d_zeroed, p38, conf))
    return {"stale": stale, "half_batch": half, "moved_2d_point": moved2d,
            "moved_3d_frame": moved3d, "zeroed_3d_frame": zeroed3d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds))
    for seed in seeds:
        s = harness.setup(cell, seed, device)
        harness.warm_up(s)
        outs = [tuple(t.cpu() for t in s.pipe(chunk)) for chunk in s.pool]
        again = [tuple(t.cpu() for t in s.pipe(chunk)) for chunk in s.pool]
        same = all(bool(torch.equal(a, b)) for x, y in zip(outs, again) for a, b in zip(x, y))
        faults = _faults(cell, s, outs) if seed in args.fault_seeds else {}
        s.pipe = None
        torch.cuda.empty_cache()
        results, rig = harness.reference_results(cell, s.pool, s.made, device, harness.ROOT)
        chunk_of = list(range(len(outs)))
        base = {"cell": cell.name, "seed": seed}
        if seed in args.seeds:
            emit({**base, "kind": "program", "repeatable": same,
                  **_numbers(cell, outs, chunk_of, results, rig)})
        for name, fouts in faults.items():
            emit({**base, "kind": "fault:" + name, **_numbers(cell, fouts, chunk_of, results, rig)})
        if seed in args.control_seeds:
            ctrl, _ = harness.reference_results(cell, s.pool, s.made, device, harness.ROOT,
                                                tf32=True)
            couts = [(r.points3d, r.points2d, r.conf) for r in ctrl.values()]
            emit({**base, "kind": "control_tf32",
                  **_numbers(cell, couts, chunk_of, results, rig)})
        del s, results
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
