"""What the benchmark may import: nothing of JAX anywhere, the program only in ``entries/``.

Imports are read from the sources (``ast``) and compared by their whole
top-level name, so ``deepfly3d_torch`` is never taken for ``deepfly3d_tpu``.
"""

import ast
import os

import pytest

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "deepfly3d_tpu"}
PROGRAM = {"deepfly3d_torch", "tests", "entries"}


def _sources(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_names_not_prefixes(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import deepfly3d_torch.ops\nfrom jaxtyping import x\n")
    assert top_level_imports(str(src)) & FORBIDDEN == set()
    src.write_text("import os\nfrom deepfly3d_tpu.models import hourglass\n")
    assert top_level_imports(str(src)) & FORBIDDEN == {"deepfly3d_tpu"}


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_in_the_benchmark(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (PROGRAM | FORBIDDEN)


def _outside(*dirs):
    """The benchmark's sources outside the directories ``dirs``."""
    return sorted(p for p in _sources()
                  if os.path.relpath(p, harness.HERE).split(os.sep)[0] not in dirs)


@pytest.mark.parametrize("path", _outside("entries", "tests"),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_only_entry_modules_import_the_program(path):
    """Every module under ``entries/`` may import the program; the harness,
    ``builders/``, ``sources/``, ``metrics/`` and ``reference/`` may not."""
    assert "deepfly3d_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "deepfly3d_tpuish", sys)
    monkeypatch.setitem(sys.modules, "jax_free.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax"]
