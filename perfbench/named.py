"""Files of the benchmark found by name: ``<directory>/<name>.py``, each loaded
once as a module of its own (a name may hold dots, as a metric's does)."""

from __future__ import annotations

import importlib.util
import os

_loaded: dict = {}


def load(directory: str, name: str):
    path = os.path.join(directory, name + ".py")
    if path not in _loaded:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: no such file of the benchmark")
        tag = os.path.basename(directory) + "_" + name.replace(".", "_")
        spec = importlib.util.spec_from_file_location("perfbench_" + tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
