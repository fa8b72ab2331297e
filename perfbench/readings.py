"""The readings that the limits of ``limits/<config>.json`` are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9] [--out FILE]

For each seed, in one process: the cell's set-up (pool, weights, the
entry's program), one call of the program on every chunk of the pool (twice:
whether the outputs repeat), and then, with the program freed, the entry's
reference on every chunk and the numbers of the entry's judge (the
program's lower readings).  For each fault seed, the same calls are judged
with each fault of the entry planted (``faults``: stale outputs, half of the
frames, a point moved one cell, and the entry's own).  For each control
seed, the reference itself, computed with TF32 on, stands in the program's
place (the control: the nearest precision below the configuration's
float32).  One JSON line per seed and kind.  The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


import harness  # noqa: E402


def _numbers(cell, outs, chunk_of, refs):
    got = harness.judge(cell, outs, chunk_of, refs)
    return {n: got[n] for n in cell.entry.NAMES + cell.entry.MAXED + ("correct",)}


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
        outs = [harness.to_host(s.prog(chunk)) for chunk in s.pool]
        again = [harness.to_host(s.prog(chunk)) for chunk in s.pool]
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for x, y in zip(outs, again) for a, b in zip(x, y))
        faults = cell.entry.faults(cell, s, outs) if seed in args.fault_seeds else {}
        s.prog = None
        torch.cuda.empty_cache()
        refs = cell.entry.reference(cell, s.pool, s.made, device, harness.ROOT)
        chunk_of = list(range(len(outs)))
        base = {"cell": cell.name, "seed": seed}
        if seed in args.seeds:
            emit({**base, "kind": "program", "repeatable": same,
                  **_numbers(cell, outs, chunk_of, refs)})
        for name, fouts in faults.items():
            emit({**base, "kind": "fault:" + name, **_numbers(cell, fouts, chunk_of, refs)})
        if seed in args.control_seeds:
            ctrl = cell.entry.reference(cell, s.pool, s.made, device, harness.ROOT, tf32=True)
            emit({**base, "kind": "control_tf32",
                  **_numbers(cell, cell.entry.control_outputs(ctrl), chunk_of, refs)})
            del ctrl
        del s, refs
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
