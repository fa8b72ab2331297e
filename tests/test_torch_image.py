"""Port's resize matrices and frame preprocess vs the JAX package's.

The resize weights are rebuilt in numpy (float64, cast to float32) and
must equal ``deepfly3d_tpu.ops.image._resize_matrix`` within 1e-7 (they are
equal bit for bit when JAX runs with x64, as the package turns it on).
The preprocess is two matmuls whose sums run in another order in each
framework: atol 1e-6 on [0, 1] pixel values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfly3d_tpu.ops import image as jax_image
from deepfly3d_torch.ops import image as port_image


@pytest.mark.parametrize("n_in,n_out", [(480, 256), (960, 512), (37, 13), (101, 64)])
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
