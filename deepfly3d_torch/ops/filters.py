"""Trajectory filters: One-Euro in 3D and 2D, and the adaptive 2D smoother.

Counterpart of ``deepfly3d_tpu/ops/filters.py``: ``filter_batch`` (the
reference's df3d/signal_util.py:69-100), ``filter_batch_2d``, the stateful
``LowPassFilter`` / ``OneEuroFilter`` of the reference's one-sample API, and
``smooth_pose2d`` (signal_util.py:135-160).  Host numpy, float64.  A One-Euro filter is two chained
first-order low-pass filters with time-varying coefficients; the JAX package
solves each as an associative scan, the port runs the recursion itself, over
T in float64, every (joint, axis) at once:

    dx_t  = (x_t - x_{t-1}) * freq_t                 (dx_0 = 0)
    edx_t = (1 - a_d) * edx_{t-1} + a_d * dx_t        (edx_0 = dx_0)
    out_t = (1 - a_x,t) * out_{t-1} + a_x,t * x_t      (out_0 = x_0)

with a(cutoff, freq) = 1 / (1 + freq / (2 pi cutoff)), cutoff_t = mincutoff
+ beta * |edx_t|, and freq_t from the timestamps (freq_0 the configured
frequency): (i + 1) * 0.1 in 3D, i * 0.1 in 2D.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

DEFAULT_ONEEURO_3D = {"freq": 100.0, "mincutoff": 0.1, "beta": 2.0, "dcutoff": 1.0}
DEFAULT_ONEEURO_2D = {"freq": 100.0, "mincutoff": 0.0001, "beta": 30.0, "dcutoff": 1.0}


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


def _filter(pts, ts, filter_indices, config_oneeuro, freq, default) -> np.ndarray:
    cfg = dict(default if config_oneeuro is None else config_oneeuro)
    if freq is not None:
        cfg["freq"] = freq
    pts = np.asarray(pts)
    out = one_euro(pts, ts, cfg["freq"], cfg["mincutoff"], cfg["beta"], cfg["dcutoff"])
    if filter_indices is not None:
        keep = np.zeros(pts.shape[1], dtype=bool)
        keep[np.asarray(filter_indices)] = True
        out = np.where(keep[None, :, None], out, pts)
    return out


def filter_batch(pts: np.ndarray, filter_indices: Optional[Sequence[int]] = None,
                 config_oneeuro: Optional[dict] = None,
                 freq: Optional[float] = None) -> np.ndarray:
    """One-Euro-filter 3D trajectories (T, J, 3): timestamps ``(i + 1) * 0.1``
    seconds whatever the recording's fps, every joint unless ``filter_indices``
    names some."""
    ts = (np.arange(np.shape(pts)[0], dtype=np.float64) + 1.0) * 0.1
    return _filter(pts, ts, filter_indices, config_oneeuro, freq, DEFAULT_ONEEURO_3D)


def filter_batch_2d(pts: np.ndarray, filter_indices: Optional[Sequence[int]] = None,
                    config_oneeuro: Optional[dict] = None,
                    freq: Optional[float] = None) -> np.ndarray:
    """One-Euro-filter 2D trajectories (T, J, 2) with timestamps ``i * 0.1``."""
    ts = np.arange(np.shape(pts)[0], dtype=np.float64) * 0.1
    return _filter(pts, ts, filter_indices, config_oneeuro, freq, DEFAULT_ONEEURO_2D)


# -------------------------------------------------- stateful API-parity shims


class LowPassFilter:
    """Stateful exponential filter (reference signal_util.py:5-28 contract)."""

    def __init__(self, alpha: float):
        self._set_alpha(alpha)
        self._y = self._s = None

    def _set_alpha(self, alpha: float):
        alpha = float(alpha)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha ({alpha}) should be in (0.0, 1.0]")
        self._alpha = alpha

    def __call__(self, value, timestamp=None, alpha=None):
        if alpha is not None:
            self._set_alpha(alpha)
        s = value if self._y is None else self._alpha * value + (1.0 - self._alpha) * self._s
        self._y = value
        self._s = s
        return s

    def lastValue(self):
        return self._y


class OneEuroFilter:
    """Stateful one-sample-at-a-time One-Euro filter, the reference class's
    call contract (signal_util.py:31-66); ``one_euro`` runs the same recursion
    over a whole trajectory."""

    def __init__(self, freq, mincutoff=1.0, beta=0.0, dcutoff=1.0):
        if freq <= 0 or mincutoff <= 0 or dcutoff <= 0:
            raise ValueError("freq, mincutoff and dcutoff must be > 0")
        self._freq = float(freq)
        self._mincutoff = float(mincutoff)
        self._beta = float(beta)
        self._dcutoff = float(dcutoff)
        self._x = LowPassFilter(self._alpha_for(self._mincutoff))
        self._dx = LowPassFilter(self._alpha_for(self._dcutoff))
        self._lasttime = None

    def _alpha_for(self, cutoff):
        tau = 1.0 / (2 * math.pi * cutoff)
        te = 1.0 / self._freq
        return 1.0 / (1.0 + tau / te)

    def __call__(self, x, timestamp=None):
        if self._lasttime and timestamp:
            self._freq = 1.0 / (timestamp - self._lasttime)
        self._lasttime = timestamp
        prev_x = self._x.lastValue()
        dx = 0.0 if prev_x is None else (x - prev_x) * self._freq
        edx = self._dx(dx, timestamp, alpha=self._alpha_for(self._dcutoff))
        cutoff = self._mincutoff + self._beta * abs(edx)
        return self._x(x, timestamp, alpha=self._alpha_for(cutoff))


# ------------------------------------------------------- adaptive 2D smoother


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _effective_window_weights(sigma: float, window: int, center: int) -> np.ndarray:
    """The weights of ``gaussian_filter1d(mode="nearest")`` at the window's
    centre: the taps beyond the window fold onto its end samples."""
    radius = int(4.0 * sigma + 0.5)
    kern = _gaussian_kernel(sigma, radius)
    w = np.zeros(window, dtype=np.float64)
    for k in range(-radius, radius + 1):
        w[min(max(center + k, 0), window - 1)] += kern[k + radius]
    return w


def smooth_pose2d(points2d: np.ndarray, window_size: int = 20, pad: int = 20,
                  std_thr: float = 5.0, sigma_smooth: float = 7.0) -> np.ndarray:
    """Adaptive per-window Gaussian smoothing of 2D tracks (T, J, 2).

    The reference's behaviour (df3d/signal_util.py:135-160): per sliding
    window of ``window_size`` samples (the track padded with ``pad`` copies
    of its end samples), smooth with sigma 7 where the window's std is below
    ``std_thr``, else keep the raw value (the reference's sigma 0.1 kernel
    has radius 0).
    """
    points2d = np.asarray(points2d, dtype=np.float64)
    T = points2d.shape[0]
    padded = np.concatenate([np.repeat(points2d[:1], pad, axis=0), points2d,
                             np.repeat(points2d[-1:], pad, axis=0)], axis=0)
    half = window_size // 2
    idx = (np.arange(T)[:, None] + pad - half) + np.arange(window_size)[None, :]
    windows = padded[idx]                                   # (T, window, J, 2)
    std = windows.std(axis=1)
    w = _effective_window_weights(sigma_smooth, window_size, half)
    smoothed = np.einsum("twjd,w->tjd", windows, w)
    return np.where(std < std_thr, smoothed, points2d)
