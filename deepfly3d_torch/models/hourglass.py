"""Stacked-hourglass architecture spec and checkpoint reader.

Counterpart of ``deepfly3d_tpu/models/hourglass.py`` (``HourglassSpec``,
``load_weights``) without flax: a checkpoint is a flat ``.npz`` whose keys
are ``a/b/c`` paths into the flax variable tree plus ``__spec__/<field>``
entries, and ``load_weights`` returns the same nested dict of numpy arrays
and the same spec fields as the JAX reader.  The forward itself lives in
``models/fused_inference.py`` (folded batch norms, CUDA blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HourglassSpec:
    """Architecture hyperparameters (same fields and defaults as the JAX spec).

    ``compute_dtype`` is a dtype name here; checkpoints never store it.
    """

    num_stacks: int = 2
    features: int = 64
    depth: int = 4
    num_blocks: int = 1
    num_classes: int = 19
    expansion: int = 2
    proj_from_raw: bool = False
    compute_dtype: str = "float32"
    bn_momentum: float = 0.99
    stem: str = "conv"
    head_upsample: int = 1
    score_ksize: int = 1
    input_shape: Optional[Tuple[int, int]] = None
    hp_scope: Optional[str] = None
    hp_precision: str = "highest"
    preprocess_dtype: str = "float32"


_STR_FIELDS = ("stem", "hp_scope", "hp_precision", "preprocess_dtype")
_INT_FIELDS = ("num_stacks", "features", "depth", "num_blocks", "num_classes",
               "expansion", "head_upsample", "score_ksize")


def _spec_value(field: str, raw: np.ndarray) -> Any:
    if field == "input_shape":
        return tuple(int(v) for v in raw)
    value = raw.item()
    if field in _STR_FIELDS:
        return str(value)
    if field == "bn_momentum":
        return float(value)
    if field == "proj_from_raw":
        return bool(int(value))
    if field in _INT_FIELDS:
        return int(value)
    raise ValueError(f"checkpoint has an unknown spec field {field!r}")


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_weights(path: str):
    """-> (variables, HourglassSpec); ``variables`` is a nested dict of numpy.

    Raises ValueError on a ``__spec__`` field the spec does not know: the
    reader never guesses what a checkpoint means.
    """
    with np.load(path) as data:
        spec_kwargs = {}
        arrays = {}
        for k in data.files:
            if k.startswith("__spec__/"):
                field = k.split("/", 1)[1]
                spec_kwargs[field] = _spec_value(field, data[k])
            else:
                arrays[k] = np.asarray(data[k])
    return _unflatten(arrays), HourglassSpec(**spec_kwargs)
