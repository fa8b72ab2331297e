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


def tiny_cell(name: str, T: int = 1, chunks: int = 2, **spec):
    """A cell of BENCHMARK.json with its traffic and, where asked, its spec cut to a test's size."""
    import harness

    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, T=T, chunks=chunks)
    if spec:
        cell.cfg = dict(cell.cfg, spec=dict(cell.cfg["spec"], **spec))
    return cell
