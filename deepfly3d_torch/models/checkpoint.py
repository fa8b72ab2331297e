"""Training-state checkpoints.

Counterpart of ``deepfly3d_tpu/models/checkpoint.py``, which writes orbax
directories; orbax is JAX's, so the port has a format of its own:

    <path>/step_<n>.pt   torch.save of the state tree at step n
    <path>/spec.json     the HourglassSpec of the last save, without
                         compute_dtype (a runtime choice, not a weight
                         property, as in JAX)

The state is any tree of dicts, lists and tuples whose leaves are tensors,
numpy arrays (saved as tensors) or Python numbers, strings and bools, such
as ``{"variables": ..., "opt": optimizer.state_dict()}``; it is read back
with ``torch.load(weights_only=True)``, which unpickles nothing else.  The
newest three steps are kept (``max_to_keep=3`` in JAX).  The portable
weights format both packages read is the flat ``.npz`` of
``models.hourglass.save_weights``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

from deepfly3d_torch.models.hourglass import HourglassSpec

MAX_TO_KEEP = 3
_STEP = re.compile(r"^step_(\d+)\.pt$")


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def _write(path: str, write) -> None:
    """Write a file through a temporary one beside it (atomic replace)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def steps(path: str) -> List[int]:
    """The steps saved under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.match, os.listdir(path)) if m)


def save_checkpoint(path: str, state: Any, step: int, spec: HourglassSpec) -> None:
    """Save ``state`` as step ``step`` under the directory ``path`` and keep
    the newest ``MAX_TO_KEEP`` steps."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    spec_dict = dataclasses.asdict(spec)
    spec_dict.pop("compute_dtype")
    _write(os.path.join(path, f"step_{int(step)}.pt"),
           lambda tmp: torch.save(_tensors(state), tmp))

    def dump(tmp):
        with open(tmp, "w") as fh:
            json.dump(spec_dict, fh, indent=1)

    _write(os.path.join(path, "spec.json"), dump)
    for old in steps(path)[:-MAX_TO_KEEP]:
        os.unlink(os.path.join(path, f"step_{old}.pt"))


def load_checkpoint(path: str, step: Optional[int] = None):
    """-> (state, HourglassSpec, step): the latest step unless ``step`` is
    given; tensors on the CPU.  Raises FileNotFoundError when there is none."""
    path = os.path.abspath(path)
    if step is None:
        saved = steps(path)
        if not saved:
            raise FileNotFoundError(f"no step_<n>.pt checkpoint under {path}")
        step = saved[-1]
    state = torch.load(os.path.join(path, f"step_{int(step)}.pt"), map_location="cpu",
                       weights_only=True)
    with open(os.path.join(path, "spec.json")) as fh:
        spec_dict = json.load(fh)
    spec_dict.pop("compute_dtype", None)
    if spec_dict.get("input_shape") is not None:
        spec_dict["input_shape"] = tuple(spec_dict["input_shape"])
    return state, HourglassSpec(**spec_dict), int(step)
