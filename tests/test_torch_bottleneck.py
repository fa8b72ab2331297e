"""Port's folded bottleneck (plain version) vs the JAX package's block.

Inputs and weights are made with numpy from a seed and handed to both
packages.  The JAX side runs its XLA oracle ``bottleneck_xla`` and the
Pallas kernel (``fused_bottleneck``, whole-image tiling v1) in interpret
mode.  f32; atol/rtol 1e-5 because the two frameworks sum in different
orders.

The row-tiled Pallas variants v3/v4 differ from the oracle on the first and
last image rows whenever a folded ``b1`` entry is positive: their halo rows
hold relu(b1) where the 3x3 convolution's zero padding belongs.  The port
follows the oracle; ``test_pallas_v4_differs_only_on_edge_rows`` pins the
reference's fault.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfly3d_tpu.ops.pallas import bottleneck as jax_bn
from deepfly3d_torch.ops import bottleneck as port_bn


def _block_params(rng, cin, cout):
    cmid = cout // 2

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    def conv(k, ci, co):
        return {"kernel": (rng.normal(0, 1, (k, k, ci, co)) / np.sqrt(k * k * ci)
                           ).astype(np.float32),
                "bias": rng.normal(0, 0.1, co).astype(np.float32)}

    params, stats = {}, {}
    for name, c in (("bn1", cin), ("bn2", cmid), ("bn3", cmid)):
        params[name], stats[name] = bn(c)
    params["conv1"] = conv(1, cin, cmid)
    params["conv2"] = conv(3, cmid, cmid)
    params["conv3"] = conv(1, cmid, cout)
    if cin != cout:
        params["proj"] = conv(1, cin, cout)
    return params, stats


# (n, h, w, cin, cout): square, non-square, projection, and a 2x wide
# "stem" case shaped like stem_res1 (48 -> 96 with projection) at 1/8 size
CASES = [
    (2, 8, 8, 16, 16),
    (1, 8, 16, 16, 16),
    (2, 4, 12, 8, 16),
    (1, 16, 32, 12, 24),
]


@pytest.mark.parametrize("n,h,w,cin,cout", CASES)
def test_plain_matches_jax(n, h, w, cin, cout):
    rng = np.random.default_rng(n * 1000 + h * 10 + cin)
    params, stats = _block_params(rng, cin, cout)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)

    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.float32)
    pf = port_bn.fold_bottleneck(params, stats)
    want_xla = np.asarray(jax_bn.bottleneck_xla(jnp.asarray(x), jf))
    want_pallas = np.asarray(
        jax_bn.fused_bottleneck(jnp.asarray(x), jf, interpret=True, version=1))
    got = port_bn.bottleneck_plain(torch.from_numpy(x), pf).numpy()

    assert got.shape == (n, h, w, cout)
    np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=1e-5)


def test_pallas_v4_differs_only_on_edge_rows():
    n, h, w, cin, cout = 1, 16, 32, 12, 24
    rng = np.random.default_rng(7)
    params, stats = _block_params(rng, cin, cout)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    pf = port_bn.fold_bottleneck(params, stats)
    got = port_bn.bottleneck_plain(torch.from_numpy(x), pf).numpy()
    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.float32)
    v4 = np.asarray(jax_bn.fused_bottleneck(jnp.asarray(x), jf, interpret=True, version=4))
    np.testing.assert_allclose(got[:, 1:-1], v4[:, 1:-1], atol=1e-5, rtol=1e-5)
    assert np.abs(got[:, [0, -1]] - v4[:, [0, -1]]).max() > 1e-2
    # with b1 <= 0 the halo's relu(b1) is zero and v4 agrees everywhere
    params["conv1"]["bias"] = np.full(cout // 2, -10.0, np.float32)
    pf = port_bn.fold_bottleneck(params, stats)
    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.float32)
    v4 = np.asarray(jax_bn.fused_bottleneck(jnp.asarray(x), jf, interpret=True, version=4))
    got = port_bn.bottleneck_plain(torch.from_numpy(x), pf).numpy()
    np.testing.assert_allclose(got, v4, atol=1e-5, rtol=1e-5)


def test_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(3)
    params, stats = _block_params(rng, 8, 16)
    pf = port_bn.fold_bottleneck(params, stats)
    x = torch.from_numpy(rng.normal(size=(1, 4, 8, 8)).astype(np.float32))
    before = port_bn.fused_bottleneck.launches
    np.testing.assert_array_equal(port_bn.fused_bottleneck(x, pf).numpy(),
                                  port_bn.bottleneck_plain(x, pf).numpy())
    assert port_bn.fused_bottleneck.launches == before   # no kernel on the CPU


def test_wrapper_rejects_bad_shapes():
    rng = np.random.default_rng(4)
    params, stats = _block_params(rng, 16, 16)
    pf = port_bn.fold_bottleneck(params, stats)
    with pytest.raises(ValueError):
        port_bn.fused_bottleneck(torch.zeros(1, 4, 4, 8), pf)      # Cin != 16
    with pytest.raises(ValueError):
        port_bn.fused_bottleneck(torch.zeros(4, 4, 16), pf)        # not NHWC
