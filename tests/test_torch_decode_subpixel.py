"""The port's soft-argmax decode (``decode_softargmax``) vs the JAX package's.

On synthetic Gaussian peaks (the style of ``tests/test_decode_subpixel.py``),
including peaks on the map borders and in the corners (the patch start
clamped, no offset at a patch border) and flat maps (the ``denom`` guard),
both methods give points within 1e-6 of JAX's and the same confidences on
identical heatmaps; the parabolic method keeps JAX's sub-0.1 px accuracy.
Through the network (golden frame 0, the conv checkpoint, both
``PoseEstimator(soft_argmax=True)`` on the CPU): the same argmax cells as
the argmax decode, confidences within 2e-5, refined points within half a
heatmap cell of the hard ones and within 1e-4 of JAX's where conf >= 0.1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfly3d_tpu.models import decode as jax_decode
from deepfly3d_tpu.models.inference import PoseEstimator as JaxEstimator
from deepfly3d_torch.models import decode as port_decode
from deepfly3d_torch.models.inference import PoseEstimator
from deepfly3d_torch.pipeline import plain_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "weights", "hourglass_fly.npz")
GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
H, W = 64, 128
PTS_ATOL = 1e-6
METHODS = ["parabolic", "window"]


def _gaussians(centers, sigma=1.5, amplitude=1.0, noise=0.0, seed=0):
    """(M, 2) cell centres -> (M, H, W, 1) float32 Gaussian peaks."""
    rr = np.arange(H, dtype=np.float64)[:, None]
    cc = np.arange(W, dtype=np.float64)[None, :]
    rng = np.random.default_rng(seed)
    maps = [amplitude * np.exp(-((rr - r) ** 2 + (cc - c) ** 2) / (2.0 * sigma ** 2))
            + noise * rng.random((H, W)) for r, c in centers]
    return np.stack(maps)[..., None].astype(np.float32)


def _both(maps, **kw):
    want = jax_decode.decode_softargmax(jnp.asarray(maps), **kw)
    got = port_decode.decode_softargmax(torch.from_numpy(maps), **kw)
    return [np.asarray(a) for a in want], [t.numpy() for t in got]


def _close(maps, **kw):
    (wp, wc), (gp, gc) = _both(maps, **kw)
    assert gp.shape == wp.shape and gc.shape == wc.shape
    np.testing.assert_allclose(gp, wp, atol=PTS_ATOL, rtol=0)
    np.testing.assert_array_equal(gc, wc)
    return gp


@pytest.fixture(scope="module")
def centers():
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(3, H - 4, 120), rng.uniform(3, W - 4, 120)], axis=1)


@pytest.mark.parametrize("method", METHODS)
def test_interior_peaks_match_jax(centers, method):
    _close(_gaussians(centers), method=method)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("sigma,amplitude,noise", [(1.0, 0.5, 0.0), (3.0, 1.2, 0.0),
                                                   (2.0, 1.0, 0.02)])
def test_peak_shapes_and_noise_match_jax(centers, method, sigma, amplitude, noise):
    _close(_gaussians(centers[:40], sigma, amplitude, noise, seed=1), method=method)


@pytest.mark.parametrize("method", METHODS)
def test_border_and_corner_peaks_match_jax(method):
    """Peaks on and beyond every border: the patch start is clamped to
    [0, H - window], and at a patch border the parabolic offset is zero."""
    border = [(0.0, 50.3), (H - 1.0, 20.7), (31.4, 0.0), (12.2, W - 1.0), (0.0, 0.0),
              (H - 1.0, W - 1.0), (-0.6, 70.2), (H - 0.4, 3.3), (1.2, 1.4),
              (H - 2.3, W - 1.6)]
    pts = _close(_gaussians(border), method=method)
    if method == "parabolic":
        cells = pts[:, 0] * [H, W]
        on_edge = np.array([[r in (0.0, H - 1.0), c in (0.0, W - 1.0)]
                            for r, c in np.round(cells)])
        np.testing.assert_array_equal(cells[on_edge], np.round(cells)[on_edge])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("value", [0.0, 0.5, 1e-14])
def test_flat_maps_hit_the_denominator_guard(method, value):
    """Flat maps: the argmax is cell (0, 0) and the log-parabola's
    denominator is 0 (or the 1e-12 floor), so no offset is applied."""
    maps = np.full((3, H, W, 2), value, np.float32)
    maps[1, 10:13, 40:43, 1] = value                      # a flat plateau stays flat
    pts = _close(maps, method=method)
    if method == "parabolic":
        np.testing.assert_array_equal(pts, 0.0)


def test_window_size_and_temperature_match_jax(centers):
    maps = _gaussians(centers[:30], sigma=2.0)
    for window, temperature in ((3, 10.0), (7, 5.0), (5, 20.0)):
        _close(maps, method="window", window=window, temperature=temperature)
        _close(maps, method="parabolic", window=window)


def test_parabolic_hits_the_north_star(centers):
    """Sub-0.1 input px on clean Gaussians (one heatmap cell is 7.5 px)."""
    maps = _gaussians(centers)
    pts = port_decode.decode_softargmax(torch.from_numpy(maps))[0].numpy()[:, 0]
    err_px = np.abs(pts * [H, W] - centers) * 7.5
    assert err_px.max() < 0.1, err_px.max()


def test_cells_come_from_the_argmax_stage(centers):
    """The refinement starts from ``argmax``'s cells: the soft-argmax stage of
    a plain twin takes them from the plain decode, with the same result."""
    maps = torch.from_numpy(_gaussians(centers[:20]))
    seen = []

    def argmax(hm):
        seen.append(hm.shape)
        return port_decode.decode_argmax(hm)

    stage = port_decode.SoftArgmaxDecode(argmax=argmax)
    got = stage(maps)
    assert seen == [maps.shape]
    want = port_decode.decode_softargmax(maps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pts, _ = port_decode.decode_argmax(maps)
    r0, c0 = port_decode.argmax_cells(pts, (H, W))
    np.testing.assert_array_equal(r0.numpy(), np.round(pts[..., 0].numpy() * H))
    assert torch.equal(port_decode.softargmax_refine(maps, r0, c0), want[0])
    with pytest.raises(ValueError, match="method"):
        port_decode.softargmax_refine(maps, r0, c0, method="global")


@pytest.fixture(scope="module")
def frame0_soft():
    """Golden frame 0 (7 cameras) through both estimators with soft_argmax,
    and the port's argmax estimator."""
    with np.load(GOLDEN_T0) as z:
        frames = z["frames"]
    flip = np.isin(np.arange(7), [4, 5, 6])
    jest = JaxEstimator(CHECKPOINT, soft_argmax=True)
    soft = PoseEstimator(CHECKPOINT, device="cpu", soft_argmax=True)
    hard = PoseEstimator(CHECKPOINT, device="cpu")
    return {"jax": jest.infer_images(frames, flip, batch_size=8),
            "soft": soft.infer_images(frames, flip, batch_size=8),
            "hard": hard.infer_images(frames, flip, batch_size=8),
            "twin": plain_twin(soft).infer_images(frames, flip, batch_size=8)}


def test_through_the_network_matches_jax(frame0_soft):
    (jp, jc), (sp, sc), (hp, hc) = (frame0_soft[k] for k in ("jax", "soft", "hard"))
    assert sp.shape == (7, 19, 2) and sc.shape == (7, 19, 1)
    np.testing.assert_array_equal(sc, hc)               # conf is the argmax stage's
    np.testing.assert_allclose(sc, jc, atol=2e-5, rtol=0)
    # the refined points stay within half a cell of their argmax cells
    assert (np.abs(sp - hp) * [H, W]).max() <= 0.5 + 1e-5
    confident = jc[..., 0] >= 0.1
    assert confident.sum() >= 100
    np.testing.assert_allclose(sp[confident], jp[confident], atol=1e-4, rtol=0)


def test_plain_twin_of_a_soft_argmax_estimator(frame0_soft):
    """On the CPU the wrapper already runs the plain decode: the same output."""
    for got, want in zip(frame0_soft["twin"], frame0_soft["soft"]):
        np.testing.assert_array_equal(got, want)
