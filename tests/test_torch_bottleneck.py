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


# ---- the kernel's arithmetic (error-compensated TF32) and its host-side helpers

# the shapes of test_plain_matches_jax plus an odd 3x6 image with and without
# projection
MODEL_CASES = CASES + [(2, 3, 6, 16, 16), (1, 3, 6, 8, 16)]


def _model_inputs(n, h, w, cin, cout):
    rng = np.random.default_rng(n * 1000 + h * 10 + cin)
    params, stats = _block_params(rng, cin, cout)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    return params, stats, x


@pytest.mark.parametrize("n,h,w,cin,cout", MODEL_CASES)
def test_tf32_model_matches_plain_and_jax(n, h, w, cin, cout):
    """Three TF32 products per product are as good as f32 sums in another
    order: within 1e-5 of the output's magnitude of the plain version and of
    the JAX oracle."""
    params, stats, x = _model_inputs(n, h, w, cin, cout)
    pf = port_bn.fold_bottleneck(params, stats)
    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.float32)
    plain = port_bn.bottleneck_plain(torch.from_numpy(x), pf).numpy()
    oracle = np.asarray(jax_bn.bottleneck_xla(jnp.asarray(x), jf))
    got = port_bn.bottleneck_tf32_model(torch.from_numpy(x), pf).numpy()
    assert got.shape == (n, h, w, cout)
    tol = 1e-5 * max(1.0, np.abs(plain).max())
    assert np.abs(got - plain).max() <= tol
    assert np.abs(got - oracle).max() <= tol


@pytest.mark.parametrize("n,h,w,cin,cout", MODEL_CASES)
def test_plain_tf32_fails_the_same_tolerance(n, h, w, cin, cout):
    """The control: one TF32 product without the two small terms misses the
    tolerance the compensated product holds, by more than ten times."""
    params, stats, x = _model_inputs(n, h, w, cin, cout)
    pf = port_bn.fold_bottleneck(params, stats)
    plain = port_bn.bottleneck_plain(torch.from_numpy(x), pf).numpy()
    got = port_bn.bottleneck_tf32_model(torch.from_numpy(x), pf, compensated=False).numpy()
    assert np.abs(got - plain).max() > 10 * 1e-5 * max(1.0, np.abs(plain).max())


def test_split_tf32_properties():
    rng = np.random.default_rng(11)
    params, stats = _block_params(rng, 48, 96)
    pf = port_bn.fold_bottleneck(params, stats)
    for name in ("w1", "w2", "w3", "wp"):
        w = pf[name]
        hi, lo = port_bn.split_tf32(w)
        for part in (hi, lo):                 # TF32 numbers: 13 zero low bits
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert (hi.abs() <= w.abs()).all()                        # cut towards zero
        assert ((w - hi).abs() <= w.abs() * 2.0 ** -10).all()
        # hi + lo gives the float32 weight back to 2^-21 of its size and more
        assert ((hi + lo - w).abs() <= w.abs() * 2.0 ** -21).all()
    zero = torch.tensor([0.0, -0.0, 1.0, -1.5])
    hi, lo = port_bn.split_tf32(zero)
    assert torch.equal(hi, zero) and not lo.any()


def _unpack_fragments(buf, k, n, order):
    """The weight matrix as the kernel's lanes read it out of ``buf``: lane
    4g+t holds, for k step ks, the rows that the A fragment's k slots t and
    t+4 stand for in this product."""
    w = np.full((k, n), np.nan, np.float32)
    buf = buf.reshape(k // 8, n // 8, 32, 2)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for ks in range(k // 8):
            k0, k1 = {"mma": (8 * ks + t, 8 * ks + t + 4),          # A from a row-major tile
                      "paired": (8 * ks + 2 * t, 8 * ks + 2 * t + 1),  # A an accumulator
                      "lanes": (t * (k // 4) + 2 * ks,              # A the lane's k/4
                                t * (k // 4) + 2 * ks + 1)}[order]  # channels of a pixel
            w[k0, g::8] = buf[ks, :, lane, 0]
            w[k1, g::8] = buf[ks, :, lane, 1]
    return w


@pytest.mark.parametrize("cin,cout", [(96, 96), (48, 96)])
def test_pack_bottleneck_holds_every_weight_once(cin, cout):
    rng = np.random.default_rng(cin)
    pf = port_bn.fold_bottleneck(*_block_params(rng, cin, cout))
    cmid, proj = cout // 2, cin != cout
    packed = port_bn.add_packed(pf)["packed"]
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() == port_bn.packed_size(cin, cmid, cout, proj)
    assert packed.numel() % 4 == 0            # copied in 16-byte pieces
    buf, o = packed.numpy(), 0
    mats = [("w1", cin, cmid, "lanes"), ("w2", 9 * cmid, cmid, "mma"),
            ("w3", cmid, cout, "paired")]
    if proj:
        mats.append(("wp", cin, cout, "lanes"))
    for name, k, n, order in mats:
        got = _unpack_fragments(buf[o:o + k * n], k, n, order)
        np.testing.assert_array_equal(got, pf[name].numpy().reshape(k, n))
        o += k * n
    b3 = pf["b3"][0] + pf["bp"][0] if proj else pf["b3"][0]
    rows = [pf["s1"][0], pf["t1"][0], pf["b1"][0], pf["b2"][0], b3]
    np.testing.assert_array_equal(buf[o:], torch.cat(rows).numpy())
    assert sorted(port_bn.add_packed(pf)) == sorted([*pf, "packed"])
    assert sorted(pf) == sorted(port_bn.fold_bottleneck(*_block_params(rng, cin, cout)))


# every (N, H, W) a path gives the kernel (PERF.md's tables): conv and p16
# levels, the patchify student's, the cascade teacher's N=7, odd test shapes
PATH_SHAPES = [(n, h, w) for n in (56, 7) for h, w in
               [(128, 256), (64, 128), (48, 96), (32, 64), (24, 48), (16, 32), (12, 24),
                (8, 16), (6, 12), (4, 8), (3, 6), (2, 4)]] + [(2, 13, 21), (1, 200, 5)]


@pytest.mark.parametrize("n,h,w", PATH_SHAPES)
@pytest.mark.parametrize("cin,proj", [(96, False), (48, True)])
def test_tile_chooser_and_shared_memory_budget(n, h, w, cin, proj):
    th, tw = port_bn.choose_tile(n, h, w, cin, 48, 96, proj)
    assert 1 <= th <= h and tw == min(w, 16)
    assert th * tw <= 192                                         # 12 warps x 16 pixels
    assert port_bn.smem_bytes(cin, 48, 96, th, tw, proj) <= port_bn.MAX_SMEM
    blocks = n * -(-h // th) * -(-w // tw)
    if n * h * w >= 16 * port_bn.NUM_SMS and w >= 8:
        assert blocks >= 0.8 * port_bn.NUM_SMS                    # the card is filled
    if n * -(-h // 8) * -(-w // 16) >= 8 * port_bn.NUM_SMS:
        assert th * tw >= 128                                     # large images: 8x16 and up
    if blocks > port_bn.NUM_SMS:      # more than one wave only with tiles worth their latency
        assert th * tw >= 64


def test_tile_chooser_fills_one_wave_at_small_shapes():
    # the conv path's small levels at T=8 and the cascade teacher's at N=7
    assert port_bn.choose_tile(56, 8, 16, 96, 48, 96, False) == (4, 16)      # 112 thread blocks
    assert port_bn.choose_tile(56, 4, 8, 96, 48, 96, False) == (2, 8)
    assert port_bn.choose_tile(56, 64, 128, 96, 48, 96, False) == (8, 16)
    assert port_bn.choose_tile(7, 32, 64, 96, 48, 96, False) == (8, 16)     # 112
    assert port_bn.choose_tile(7, 16, 32, 96, 48, 96, False) == (2, 16)
    assert port_bn.choose_tile(1, 1, 1, 96, 48, 96, False) == (1, 1)


def test_shared_memory_budget_numbers():
    # the 96->48->96 block: 121,344 bytes of weights, and a2 twice on the halo
    # pixels (180 for an 8x16 tile, 252 for the largest, 12x16)
    assert port_bn.packed_size(96, 48, 96, False) * 4 == 121344
    assert port_bn.smem_bytes(96, 48, 96, 8, 16, False) == 121344 + 2 * 180 * 52 * 4 == 196224
    assert port_bn.smem_bytes(96, 48, 96, 12, 16, False) == 226176 <= port_bn.MAX_SMEM
    assert port_bn.smem_bytes(48, 48, 96, 8, 16, True) == 205056
    assert port_bn.smem_bytes(48, 48, 96, 12, 16, True) > port_bn.MAX_SMEM   # 11 rows fit
    with pytest.raises(ValueError):
        port_bn.choose_tile(1, 8, 16, 256, 128, 256, False)       # weights alone too large
    assert (96, 48, 96, False) in port_bn.INSTANCES and (48, 48, 96, True) in port_bn.INSTANCES


def test_streamed_w2_budget_numbers():
    # the 128-wide blocks: every weight resident does not fit even one row of
    # 16 pixels, so w2 streams through a ring of two 16 KB taps
    for block in ((128, 64, 128, False), (64, 64, 128, True)):
        assert block in port_bn.INSTANCES and port_bn.streams_w2(*block)
        assert port_bn.packed_size(*block) * 4 + 2 * 3 * 18 * 68 * 4 > port_bn.MAX_SMEM
    assert not any(port_bn.streams_w2(*b) for b in port_bn.INSTANCES[:4])
    assert port_bn.smem_bytes(128, 64, 128, 8, 16, False) == 4 * (16896 + 8192) + 97920 \
        == 198272
    assert port_bn.smem_bytes(64, 64, 128, 8, 16, True) == 214144
    assert port_bn.smem_bytes(128, 64, 128, 11, 16, False) <= port_bn.MAX_SMEM
    assert port_bn.smem_bytes(128, 64, 128, 12, 16, False) > port_bn.MAX_SMEM
    assert port_bn.smem_bytes(64, 64, 128, 9, 16, True) <= port_bn.MAX_SMEM
    assert port_bn.smem_bytes(64, 64, 128, 10, 16, True) > port_bn.MAX_SMEM


H36M_SHAPES = [(8, 192, 192), (8, 96, 96), (8, 48, 48), (8, 24, 24), (8, 12, 12), (8, 6, 6),
               (3, 19, 37), (1, 1, 1)]


@pytest.mark.parametrize("n,h,w", H36M_SHAPES)
@pytest.mark.parametrize("cin,proj", [(128, False), (64, True)])
def test_tile_chooser_at_the_h36m_shapes(n, h, w, cin, proj):
    th, tw = port_bn.choose_tile(n, h, w, cin, 64, 128, proj)
    assert 1 <= th <= h and tw == min(w, 16) and th * tw <= 192
    assert port_bn.smem_bytes(cin, 64, 128, th, tw, proj) <= port_bn.MAX_SMEM
    blocks = n * -(-h // th) * -(-w // tw)
    if n * h * w >= 16 * port_bn.NUM_SMS and w >= 8:
        assert blocks >= 0.8 * port_bn.NUM_SMS                    # the card is filled
