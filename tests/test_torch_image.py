"""Port's resize matrices and frame preprocess vs the JAX package's.

The resize weights are rebuilt in numpy (float64, cast to float32) and
must equal ``deepfly3d_tpu.ops.image._resize_matrix`` within 1e-7 (they are
equal bit for bit when JAX runs with x64, as the package turns it on).
The preprocess is two matmuls whose sums run in another order in each
framework: atol 1e-6 on [0, 1] pixel values.  The preprocess kernel's tap
tables (``resize_taps``) must rebuild the matrices exactly, and the port's
``preprocess_frames`` must agree within 1e-6 with the composition its
docstring names: ``jax.image.resize(preprocess_u8_pallas(x, flip))``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfly3d_tpu.ops import image as jax_image
from deepfly3d_tpu.ops.pallas import kernels as jax_kernels
from deepfly3d_torch.ops import image as port_image


@pytest.mark.parametrize("n_in,n_out", [(480, 256), (960, 512), (37, 13), (101, 64), (1000, 384)])
def test_resize_matrix_matches_jax(n_in, n_out):
    want = jax_image._resize_matrix(n_in, n_out)
    got = port_image._resize_matrix(n_in, n_out)
    assert got.shape == want.shape == (n_out, n_in)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("flip", [(False, False, False), (True, False, True)])
def test_preprocess_frames_matches_jax(flip):
    rng = np.random.default_rng(sum(flip))
    frames = rng.integers(0, 256, size=(3, 48, 96, 3), dtype=np.uint8)
    flip = np.asarray(flip)
    want = np.asarray(jax_image.preprocess_frames(
        jnp.asarray(frames), jnp.asarray(flip), (32, 64)))
    got = port_image.preprocess_frames(
        torch.from_numpy(frames), torch.from_numpy(flip), (32, 64)).numpy()
    assert got.shape == (3, 32, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(480, 256), (960, 512), (480, 192), (960, 384),
                                        (480, 480), (37, 13), (101, 64), (1000, 384)])
@pytest.mark.parametrize("scale", [1.0, 1.0 / 255.0])
def test_resize_taps_rebuild_matrix(n_in, n_out, scale):
    starts, weights = port_image.resize_taps(n_in, n_out, scale)
    k = weights.shape[1]
    assert starts.dtype == np.int32 and weights.dtype == np.float32
    assert starts.shape == (n_out,) and starts.min() >= 0 and starts.max() + k <= n_in
    rebuilt = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        rebuilt[o, starts[o]:starts[o] + k] = weights[o]
    want = jax_image._resize_matrix(n_in, n_out) * np.float32(scale)
    np.testing.assert_array_equal(rebuilt, want)
    if n_in == n_out:
        assert k == 1 and np.all(weights == np.float32(scale))


@pytest.mark.parametrize("in_hw,out_hw", [((48, 96), (32, 64)), ((60, 120), (24, 48)),
                                          ((37, 50), (13, 29))])
def test_preprocess_frames_matches_resize_of_pallas(in_hw, out_hw):
    rng = np.random.default_rng(in_hw[0])
    frames = rng.integers(0, 256, size=(4,) + in_hw + (3,), dtype=np.uint8)
    flip = np.array([False, True, True, False])
    x = jax_kernels.preprocess_u8_pallas(jnp.asarray(frames), jnp.asarray(flip))
    want = np.asarray(jax.image.resize(x, (4,) + out_hw + (3,), method="bilinear"))
    got = port_image.preprocess_frames(torch.from_numpy(frames), torch.from_numpy(flip),
                                       out_hw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_hw", [(256, 512), (192, 384)])
def test_interpolate_antialias_is_the_same_resize(out_hw):
    """``F.interpolate(bilinear, antialias=True)``, the library yardstick the
    smoke script times for the preprocess kernel, computes the same function."""
    rng = np.random.default_rng(out_hw[0])
    frames = torch.from_numpy(rng.integers(0, 256, size=(2, 480, 960, 3), dtype=np.uint8))
    flip = torch.tensor([False, True])
    want = port_image.preprocess_frames_plain(frames, flip, out_hw)
    x = (frames.float() * (1.0 / 255.0)).permute(0, 3, 1, 2)
    got = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear", antialias=True,
                                          align_corners=False).permute(0, 2, 3, 1)
    got = torch.where(flip.reshape(2, 1, 1, 1), got.flip(2), got)
    assert got.shape == want.shape == (2,) + out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_preprocess_dtype_other_than_float32_raises():
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_image.preprocess_frames(frames, torch.zeros(1, dtype=torch.bool), (4, 4),
                                     "float16")
