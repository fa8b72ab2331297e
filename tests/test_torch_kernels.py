"""Port's upsample-add and decode (plain versions) vs the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU.  The upsample-add is
exact (atol 0).  The decode is exact too, checked on maps with planted
ties: between equal maxima the first flat index must win, as jnp.argmax.
The preprocess is exact as well: ``preprocess_u8_plain`` is the Pallas
kernel's function, and the port's resize wrapper at out shape == in shape
(identity taps) computes the same values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfly3d_tpu.models import decode as jax_decode
from deepfly3d_tpu.ops.pallas import kernels as jax_kernels
from deepfly3d_torch.models import decode as port_decode
from deepfly3d_torch.ops import image as port_image
from deepfly3d_torch.ops import kernels as port_kernels


@pytest.mark.parametrize("shape", [(2, 4, 8, 16), (1, 8, 16, 8), (3, 3, 5, 4)])
def test_upsample2x_add_matches_pallas(shape):
    n, h, w, c = shape
    rng = np.random.default_rng(sum(shape))
    inner = rng.normal(size=shape).astype(np.float32)
    skip = rng.normal(size=(n, 2 * h, 2 * w, c)).astype(np.float32)
    want = np.asarray(jax_kernels.upsample2x_add_pallas(jnp.asarray(inner), jnp.asarray(skip)))
    got = port_kernels.upsample2x_add_plain(torch.from_numpy(inner), torch.from_numpy(skip))
    np.testing.assert_array_equal(got.numpy(), want)
    wrapped = port_kernels.upsample2x_add(torch.from_numpy(inner), torch.from_numpy(skip))
    np.testing.assert_array_equal(wrapped.numpy(), want)


def _tied_heatmaps(seed, n=3, h=16, w=32, k=5):
    """Maps whose maximum appears at several cells (and one all-equal map)."""
    rng = np.random.default_rng(seed)
    hm = rng.normal(size=(n, h, w, k)).astype(np.float32)
    for i in range(n):
        for j in range(k):
            cells = rng.choice(h * w, size=1 + (i + j) % 4, replace=False)
            peak = np.float32(5.0 + j)
            hm[i].reshape(h * w, k)[cells, j] = peak
    hm[0, :, :, 0] = 1.5          # every cell tied: first index is 0
    return hm


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_pallas_and_decode_argmax(seed):
    hm = _tied_heatmaps(seed)
    pts_p, conf_p = jax_kernels.decode_heatmaps_pallas(jnp.asarray(hm))
    pts_r, conf_r = jax_decode.decode_argmax(jnp.asarray(hm))
    pts, conf = port_kernels.decode_heatmaps_plain(torch.from_numpy(hm))
    for want_pts, want_conf in ((pts_p, conf_p), (pts_r, conf_r)):
        np.testing.assert_array_equal(pts.numpy(), np.asarray(want_pts))
        np.testing.assert_array_equal(conf.numpy(), np.asarray(want_conf))
    assert pts[0, 0].tolist() == [0.0, 0.0]
    via_model = port_decode.decode_argmax(torch.from_numpy(hm))
    np.testing.assert_array_equal(via_model[0].numpy(), pts.numpy())


def test_first_index_tie_break_explicit():
    hm = np.zeros((1, 4, 8, 2), np.float32)
    hm[0, 1, 3, 0] = hm[0, 2, 1, 0] = 2.0     # flat 11 and 17 tie: 11 wins
    hm[0, 3, 7, 1] = hm[0, 0, 6, 1] = 1.0     # flat 31 and 6 tie: 6 wins
    pts, conf = port_kernels.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(pts.numpy()[0], [[1 / 4, 3 / 8], [0.0, 6 / 8]])
    np.testing.assert_array_equal(conf.numpy()[0, :, 0], [2.0, 1.0])


def test_postprocess_points2d_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(0.05, 0.95, size=(7, 3, 19, 2))
    order = [0, 1, 2, 3, 4, 5, 6]
    np.testing.assert_array_equal(
        port_decode.postprocess_points2d(pts, order),
        jax_decode.postprocess_points2d(pts, order))


@pytest.mark.parametrize("shape", [(4, 12, 20, 3), (3, 7, 9, 3), (2, 5, 16, 1)])
def test_preprocess_u8_plain_equals_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, size=shape, dtype=np.uint8)
    frames[0, 0, 0] = 255
    frames[-1, -1, -1] = 0
    flip = (np.arange(shape[0]) % 2).astype(bool)
    want = np.asarray(jax_kernels.preprocess_u8_pallas(jnp.asarray(frames), jnp.asarray(flip)))
    got = port_kernels.preprocess_u8_plain(torch.from_numpy(frames), torch.from_numpy(flip))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    n, h, w, _ = shape
    for resized in (port_kernels.preprocess_resize(torch.from_numpy(frames),
                                                   torch.from_numpy(flip), (h, w)),
                    port_image.preprocess_frames(torch.from_numpy(frames),
                                                 torch.from_numpy(flip), (h, w))):
        np.testing.assert_array_equal(resized.numpy(), want)


def test_preprocess_resize_rejects_bad_inputs():
    frames = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_kernels.preprocess_resize(frames.float(), torch.zeros(2, dtype=torch.bool), (4, 4))
    with pytest.raises(ValueError):
        port_kernels.preprocess_resize(frames, torch.zeros(3, dtype=torch.bool), (4, 4))
    with pytest.raises(ValueError):
        port_kernels.preprocess_resize(frames, torch.zeros(2, dtype=torch.int32), (4, 4))


def _special_heatmaps(shape, seed):
    """Random maps with a NaN, a map of -0.0 holding one later +0.0 (they tie:
    the first index wins), and two planted ties."""
    n, h, w, k = shape
    rng = np.random.default_rng(seed)
    hm = rng.normal(size=shape).astype(np.float32)
    hm[0, :, :, 0] = -0.0
    hm[0, h - 1, w - 2, 0] = 0.0
    hm[0, h // 2, w // 3, 1] = np.nan                  # beats every number
    hm[-1, 1, 1, 2] = hm[-1, h - 1, 0, 2] = 9.0        # first of two peaks
    hm[-1, 2, 1, k - 1] = hm[-1, 2, 2, k - 1] = np.nan    # first of two NaNs
    return hm


# (N, H, W, K); 7x9x19 and 5x5x3: K x cells is no multiple of 4
@pytest.mark.parametrize("shape", [(2, 16, 32, 5), (3, 7, 9, 19), (2, 5, 5, 3), (1, 8, 16, 19)])
def test_decode_nan_signed_zero_and_ragged_shapes(shape):
    n, h, w, k = shape
    hm = _special_heatmaps(shape, seed=sum(shape))
    pts, conf = port_kernels.decode_heatmaps_plain(torch.from_numpy(hm))
    wrapped = port_kernels.decode_heatmaps(torch.from_numpy(hm))
    flat = jnp.asarray(hm).transpose(0, 3, 1, 2).reshape(n, k, h * w)
    idx = np.asarray(jnp.argmax(flat, axis=-1))
    want_pts = np.stack([(idx // w).astype(np.float32) / np.float32(h),
                         (idx % w).astype(np.float32) / np.float32(w)], -1)
    pts_p, conf_p = jax_kernels.decode_heatmaps_pallas(jnp.asarray(hm))
    for got_pts, got_conf in ((pts, conf), wrapped):
        np.testing.assert_array_equal(got_pts.numpy(), want_pts)
        # the same cells as the Pallas kernel; under jit XLA divides by a grid
        # size that is no power of two as a product with its reciprocal, one
        # ulp off the IEEE division, so cells (>= 1/32 apart) compare to 1e-6
        np.testing.assert_allclose(got_pts.numpy(), np.asarray(pts_p), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got_conf.numpy(), np.asarray(conf_p))   # NaN == NaN here
        np.testing.assert_array_equal(got_conf.numpy()[..., 0], np.asarray(jnp.max(flat, -1)))
    assert pts[0, 0].tolist() == [0.0, 0.0]                       # -0.0 == +0.0
    assert np.isnan(conf.numpy()[0, 1, 0])
    assert pts[0, 1].tolist() == [np.float32(h // 2) / np.float32(h),
                                  np.float32(w // 3) / np.float32(w)]
    assert pts[-1, k - 1].tolist() == [np.float32(2) / np.float32(h),
                                       np.float32(1) / np.float32(w)]


@pytest.mark.parametrize("n,cells,want", [(56, 64 * 128, 5), (56, 48 * 96, 5), (7, 64 * 128, 38),
                                          (1, 64 * 128, 128), (3, 63, 1), (500, 8192, 1)])
def test_decode_splits(n, cells, want):
    splits = port_kernels.decode_splits(n, cells)
    assert splits == want
    assert 1 <= splits <= cells
    if cells >= 64 * 264:
        assert n * splits >= 264          # two thread blocks per SM of an H100
