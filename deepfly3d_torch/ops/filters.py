"""The 3D One-Euro trajectory filter (``filter_batch``).

Counterpart of ``deepfly3d_tpu/ops/filters.py::filter_batch`` (the
reference's df3d/signal_util.py:69-100).  A One-Euro filter is two chained
first-order low-pass filters with time-varying coefficients; the JAX package
solves each as an associative scan, the port runs the recursion itself, over
T in float64, every (joint, axis) at once:

    dx_t  = (x_t - x_{t-1}) * freq_t                 (dx_0 = 0)
    edx_t = (1 - a_d) * edx_{t-1} + a_d * dx_t        (edx_0 = dx_0)
    out_t = (1 - a_x,t) * out_{t-1} + a_x,t * x_t      (out_0 = x_0)

with a(cutoff, freq) = 1 / (1 + freq / (2 pi cutoff)), cutoff_t = mincutoff
+ beta * |edx_t|, and freq_t from the timestamps (i + 1) * 0.1 (freq_0 the
configured frequency).  The 2D smoothers come later (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

DEFAULT_ONEEURO_3D = {"freq": 100.0, "mincutoff": 0.1, "beta": 2.0, "dcutoff": 1.0}


def _alpha(cutoff, freq):
    tau = 1.0 / (2.0 * math.pi * cutoff)
    return 1.0 / (1.0 + tau * freq)


def one_euro(x: np.ndarray, timestamps: np.ndarray, freq: float = 100.0,
             mincutoff: float = 0.1, beta: float = 2.0, dcutoff: float = 1.0) -> np.ndarray:
    """One-Euro filter along axis 0 of ``x`` (T, ...), float64."""
    x = np.asarray(x, np.float64)
    freq_t = np.concatenate([[freq], 1.0 / np.diff(np.asarray(timestamps, np.float64))])
    out = np.empty_like(x)
    out[0] = x[0]
    edx = np.zeros_like(x[0])                # edx_0 = dx_0 = 0
    for t in range(1, x.shape[0]):
        dx = (x[t] - x[t - 1]) * freq_t[t]
        a_d = _alpha(dcutoff, freq_t[t])
        edx = (1.0 - a_d) * edx + a_d * dx
        a_x = _alpha(mincutoff + beta * np.abs(edx), freq_t[t])
        out[t] = (1.0 - a_x) * out[t - 1] + a_x * x[t]
    return out


def filter_batch(pts: np.ndarray, filter_indices: Optional[Sequence[int]] = None,
                 config_oneeuro: Optional[dict] = None,
                 freq: Optional[float] = None) -> np.ndarray:
    """One-Euro-filter 3D trajectories (T, J, 3): timestamps ``(i + 1) * 0.1``
    seconds whatever the recording's fps, every joint unless ``filter_indices``
    names some."""
    cfg = dict(DEFAULT_ONEEURO_3D if config_oneeuro is None else config_oneeuro)
    if freq is not None:
        cfg["freq"] = freq
    pts = np.asarray(pts)
    ts = (np.arange(pts.shape[0], dtype=np.float64) + 1.0) * 0.1
    out = one_euro(pts, ts, cfg["freq"], cfg["mincutoff"], cfg["beta"], cfg["dcutoff"])
    if filter_indices is not None:
        keep = np.zeros(pts.shape[1], dtype=bool)
        keep[np.asarray(filter_indices)] = True
        out = np.where(keep[None, :, None], out, pts)
    return out
