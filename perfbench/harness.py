"""One run of one cell: set-up, the measured window, the check, the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a file found by its name (``configs/<config>.json``, ``traffic/<traffic>.json``),
with the configuration's limits in ``limits/<config>.json`` (each number
that the cell's entry judges, with its limit), its weights made, and their
shapes given for the counts, by ``builders/<builder>.py``, the path it
drives with its reference and judge in ``entries/<entry>.py`` and its frames
in ``sources/<source>.py`` (both named by the traffic mix), and every
per-layer metric read by ``metrics/<name>.py``.  Nothing here names a cell,
an entry or a source.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

import entries
import named

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:            # the program under test, deepfly3d_torch, lives there
    sys.path.append(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfly3d_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock-tick resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell's entry, configuration, traffic mix, limits and metric lists."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]

    def reports(m):
        return name in m.get("workloads", [name])

    cfg = _json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    mix = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return SimpleNamespace(
        name=name, chips=int(cell["chips"]), cfg=cfg, mix=mix, entry=entries.of(mix),
        limits=_json(os.path.join(HERE, "limits", cell["config"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def check_data(cell: SimpleNamespace, root: str) -> None:
    """Every data file the run reads holds the bytes its configuration states."""
    import generator

    for rel, want in cell.cfg.get("data_sha256", {}).items():
        with open(os.path.join(root, rel), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise RuntimeError(f"{rel}: sha256 {got}, the configuration states {want}")
    if generator.source(cell.mix).digest(root) != cell.mix["recording_sha256"]:
        raise RuntimeError("the frame source is not the recording the traffic mix states")


def builder(cfg: dict):
    return importlib.import_module("builders." + cfg["builder"])


def metric_reader(name: str):
    return named.load(os.path.join(HERE, "metrics"), name).read


class Setup(SimpleNamespace):
    """What set-up made: ``prog`` (the program of ``entry``), ``pool``, ``made``
    (the builder's), ``device``, ``recording`` (the source's frames, numpy)
    and ``stages``."""


def setup(cell: SimpleNamespace, seed: int, device, root: str = ROOT) -> Setup:
    """Data checked, the source's frames decoded, the chunk pool and the
    weights made from the seed, the entry's program built; ``stages`` holds
    the seconds of each."""
    import torch

    import generator

    stages = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    check_data(cell, root)
    recording = generator.source(cell.mix).load(root)
    lap("data")
    pool = generator.make_pool(torch.from_numpy(recording).to(device), cell.mix, seed)
    lap("pool")
    made = builder(cell.cfg).make(cell.cfg, root, seed, device)
    lap("weights")
    prog = cell.entry.build(cell, root, made, device)
    lap("program")
    return Setup(prog=prog, entry=cell.entry, pool=pool, made=made, device=device,
                 recording=recording, stages=stages)


def to_host(outs):
    return tuple(t.cpu() if hasattr(t, "cpu") else t for t in outs)


def warm_up(s: Setup, calls: int = 2) -> None:
    """The cell's one shape, through the call and the copy back, twice
    (the first call loads the program's kernels, building any that the
    checkout lacks)."""
    t = time.perf_counter()
    for i in range(calls):
        to_host(s.prog(s.pool[i % len(s.pool)]))
    _sync(s.device)
    s.stages["warm_up"] = time.perf_counter() - t


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(s: Setup, seconds: float, traced: bool = False) -> SimpleNamespace:
    """Calls round robin over the pool until ``seconds`` have passed; each
    call's outputs on the host before the next call starts.  -> the calls'
    times, host times inside the call, outputs, chunk indices, the window's
    length, and the profiler (traced runs)."""
    import torch

    prof = None
    if traced:
        from devtrace import PREFIX

        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()

    def span(name):
        return torch.profiler.record_function(PREFIX + name) if traced else _Null()

    times, inside, outputs, chunk_of = [], [], [], []
    n = len(s.pool)
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    with span("window"):
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            k = len(times) % n
            start = time.perf_counter()
            with span("call"):
                outs = s.prog(s.pool[k])
            returned = time.perf_counter()
            with span("to_host"):
                host = to_host(outs)
            end = time.perf_counter()
            times.append(end - start)
            inside.append(returned - start)
            outputs.append(host)
            chunk_of.append(k)
    if prof is not None:
        prof.__exit__(None, None, None)
    return SimpleNamespace(t0=t0, times=times, inside=inside, outputs=outputs,
                           chunk_of=chunk_of, seconds=end - t0, prof=prof)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def judge(cell: SimpleNamespace, outputs, chunk_of, refs) -> Dict:
    """The entry's numbers, the worst over every call of the window, with its
    counts combined (``MAXED``, ``SUMMED``), ``failed`` (calls with a number
    over its limit) and ``correct``.  Calls whose outputs hold the same bytes
    for the same chunk are judged once."""
    entry = cell.entry
    groups: Dict = {}
    for out, k in zip(outputs, chunk_of):
        arrays = tuple(np.asarray(t) for t in out)
        key = (k, hashlib.sha256(b"".join(a.tobytes() for a in arrays)).digest())
        groups.setdefault(key, [arrays, 0])[1] += 1
    got: Dict = {n: 0.0 for n in entry.NAMES}
    got.update({n: 0 for n in entry.MAXED + entry.SUMMED})
    got.update(failed=0, distinct_outputs=len(groups))
    for (k, _), (arrays, count) in groups.items():
        one = entry.judge_call(cell, arrays, refs, k)
        for n in entry.NAMES + entry.MAXED:
            got[n] = max(got[n], one[n])
        for n in entry.SUMMED:
            got[n] += one[n]
        got["failed"] += count * any(not one[n] <= cell.limits[n] for n in entry.NAMES)
    got["correct"] = bool(groups) and got["failed"] == 0
    return got


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
