"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from the repository root.

They run on the CPU, where every kernel of the program runs its plain
version; the tests marked ``gpu`` need a card and skip without one.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


class CallClock:
    """A stand-in for the harness's clock that advances ``tick`` seconds at
    every read: a window of ``seconds`` holds a number of calls fixed by the
    reads a call makes (three), whatever the machine's speed."""

    def __init__(self, tick: float = 0.1):
        self.now, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


@pytest.fixture
def call_clock(monkeypatch):
    """The harness timed by ``CallClock``: a window of 1.0 s holds 4 calls."""
    import harness

    clock = CallClock()
    monkeypatch.setattr(harness, "time", clock)
    return clock


def mix_cell(name: str, traffic: str) -> object:
    """A cell of BENCHMARK.json with another traffic mix of ``traffic/`` and its entry."""
    import json

    import entries
    import harness

    cell = harness.load_cell(name)
    with open(os.path.join(HERE, "traffic", traffic + ".json")) as f:
        cell.mix = json.load(f)
    cell.entry = entries.of(cell.mix)
    return cell


def tiny_cell(name: str, T: int = 1, chunks: int = 2, **spec):
    """A cell of BENCHMARK.json with its traffic and, where asked, its spec cut to a test's size."""
    import harness

    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, T=T, chunks=chunks)
    if spec:
        cell.cfg = dict(cell.cfg, spec=dict(cell.cfg["spec"], **spec))
    return cell
