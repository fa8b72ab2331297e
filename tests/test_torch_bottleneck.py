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


# the fly float32 instances (csrc/bottleneck.cu), each projecting one also with
# the raw-input projection: (Cin, Cmid, Cout, projects, raw)
FLY_INSTANCES = [(96, 48, 96, False, False), (48, 48, 96, True, False), (48, 48, 96, True, True),
                 (64, 32, 64, False, False), (32, 32, 64, True, False), (32, 32, 64, True, True)]


def _unpack_tf32(flat, k, n, order, cols=64):
    """``_pack_tf32``'s layout (passes of ``cols`` columns) back to (K, N) hi
    and lo, and the count of slots that hold each (k, n)."""
    steps = k // 8
    arr = flat.reshape(n // cols, steps, 2, cols // 8, 2, 8, 4)   # pass, step, hi/lo, grp, kc, col, j
    p, s, part, grp, kc, col, j = np.meshgrid(*(np.arange(d) for d in arr.shape), indexing="ij")
    ch = 8 * s + 2 * j + kc if order == "pair" else 16 * (s // 2) + 4 * j + 2 * (s % 2) + kc
    cols = cols * p + 8 * grp + col
    hi, lo = np.zeros((k, n), np.float32), np.zeros((k, n), np.float32)
    count = np.zeros((k, n), np.int64)
    hi[ch[:, :, 0], cols[:, :, 0]] = arr[:, :, 0]
    lo[ch[:, :, 1], cols[:, :, 1]] = arr[:, :, 1]
    np.add.at(count, (ch[:, :, 0], cols[:, :, 0]), 1)
    return hi, lo, count


@pytest.mark.parametrize("cin,cmid,cout,proj,raw", FLY_INSTANCES)
def test_pack_bottleneck_holds_every_weight_once(cin, cmid, cout, proj, raw):
    """The fly float32 layout, unpacked section by section: w1, w2, w3 and wp
    each once as hi and lo, hi + lo == w bit for bit, hi a TF32 number, every
    section 16-byte aligned, the resident part (vectors, w1, w3, wp) ahead of
    w2, b3 + bp folded; the kernel's copies of it are whole 16-byte pieces."""
    rng = np.random.default_rng(cin + raw)
    params, stats = _block_params(rng, cin, cout)
    assert ("proj" in params) == proj and cout // 2 == cmid
    pf = port_bn.fold_bottleneck(params, stats, proj_from_raw=raw)
    packed = port_bn.add_packed(pf)["packed"]
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert not port_bn.streams_w2(cin, cmid, cout, proj)
    assert packed.numel() == port_bn.packed_size(cin, cmid, cout, proj)
    buf = packed.numpy()
    sections = port_bn.sections_fly(cin, cmid, cout, proj)
    assert sum(b for _, b in sections.values()) == 4 * buf.size
    assert all(at % 16 == 0 and b % 16 == 0 for at, b in sections.values())
    assert list(sections)[-1] == "w2"                   # the resident part comes first
    f = {k: v.numpy() for k, v in pf.items() if k != "proj_raw"}
    want = {"s1": f["s1"][0], "t1": f["t1"][0], "b1": f["b1"][0], "b2": f["b2"][0],
            "b3": f["b3"][0] + f["bp"][0] if proj else f["b3"][0]}
    for name, v in want.items():
        at, nbytes = sections[name]
        np.testing.assert_array_equal(buf[at // 4:(at + nbytes) // 4], v)
    mats = {"w1": (f["w1"], "quad"), "w3": (f["w3"], "pair"),
            "w2": (f["w2"].reshape(9 * cmid, cmid), "pair")}
    if proj:
        mats["wp"] = (f["wp"], "quad")
    assert sorted(mats) == sorted(k for k in sections if k.startswith("w"))
    for name, (w, order) in mats.items():
        at, nbytes = sections[name]
        hi, lo, count = _unpack_tf32(buf[at // 4:(at + nbytes) // 4], *w.shape, order,
                                     cols=w.shape[1])
        assert (count == 1).all(), name
        assert ((hi.view(np.int32) & 0x1FFF) == 0).all(), name
        np.testing.assert_array_equal(hi + lo, w, err_msg=name)
        np.testing.assert_array_equal(lo, w - hi, err_msg=name)
    assert sorted(port_bn.add_packed(pf)) == sorted([*pf, "packed"])
    assert sorted(pf) == sorted(port_bn.fold_bottleneck(*_block_params(rng, cin, cout),
                                                        proj_from_raw=raw))


# every (N, H, W) a path gives the kernel (PERF.md's tables): conv and p16
# levels, the patchify student's, the cascade teacher's N=7, odd test shapes
PATH_SHAPES = [(n, h, w) for n in (56, 7) for h, w in
               [(128, 256), (64, 128), (48, 96), (32, 64), (24, 48), (16, 32), (12, 24),
                (8, 16), (6, 12), (4, 8), (3, 6), (2, 4)]] + [(2, 13, 21), (1, 200, 5)]


@pytest.mark.parametrize("n,h,w", PATH_SHAPES)
@pytest.mark.parametrize("cin,cmid,cout,proj", [b[:4] for b in FLY_INSTANCES if not b[4]])
def test_tile_chooser_and_shared_memory_budget(n, h, w, cin, cmid, cout, proj):
    th, tw = port_bn.choose_tile(n, h, w, cin, cmid, cout, proj)
    assert 1 <= th <= h and tw == min(w, 16)
    assert th * tw <= port_bn.RING_TILE_PIXELS                   # two m64 row blocks
    assert (th + 2) * (tw + 2) <= port_bn.RING_HALO_PIXELS       # three in stage 1
    assert port_bn.tile_fits_fly(th, tw, cin, cmid, cout, proj)
    smem, stages = port_bn._layout_fly(cin, cmid, cout, th, tw, proj)
    assert smem == port_bn.smem_bytes(cin, cmid, cout, th, tw, proj) <= port_bn.MAX_SMEM
    assert port_bn.FLY_STAGES[0] <= stages <= port_bn.FLY_STAGES[1]
    blocks = n * -(-h // th) * -(-w // tw)
    if n * h * w >= 16 * port_bn.NUM_SMS and w >= 8:
        assert blocks >= 0.8 * port_bn.NUM_SMS                    # the card is filled
    if n * -(-h // 8) * -(-w // 16) >= 8 * port_bn.NUM_SMS:
        assert th * tw >= 128                                     # large images: 8x16
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


@pytest.mark.parametrize("cin,cmid,cout,proj,resident", [
    (96, 48, 96, False, 75264), (48, 48, 96, True, 93312),
    (64, 32, 64, False, 33792), (32, 32, 64, True, 41728)])
def test_shared_memory_budget_numbers(cin, cmid, cout, proj, resident):
    # the fly blocks: 128 bytes of mbarriers, the vectors, w1, w3 (and wp)
    # resident as hi and lo, a ring of three whole taps of w2 (Cmid x Cmid x 8
    # bytes: 18 KB at 48, 8 KB at 32), and one a2 on the halo pixels (180 for
    # an 8x16 tile, the largest; 192 halo pixels at most, 128 tile pixels)
    tap = 8 * cmid * cmid
    assert port_bn.sections_fly(cin, cmid, cout, proj)["w2"] == (resident, 9 * tap)
    assert port_bn.packed_size(cin, cmid, cout, proj) * 4 == resident + 9 * tap
    assert port_bn.smem_bytes(cin, cmid, cout, 8, 16, proj) == \
        128 + resident + 3 * tap + 180 * cmid * 4 <= port_bn.MAX_SMEM
    assert port_bn._layout_fly(cin, cmid, cout, 8, 16, proj)[1] == port_bn.FLY_STAGES[1] == 3
    assert port_bn._layout_fly(cin, cmid, cout, 1, 1, proj)[1] == 3
    assert port_bn.tile_fits_fly(8, 16, cin, cmid, cout, proj)
    assert not port_bn.tile_fits_fly(9, 16, cin, cmid, cout, proj)    # 144 pixels: three row blocks
    assert port_bn.tile_fits_fly(10, 12, cin, cmid, cout, proj)       # 12 x 14 halo: 168 <= 192
    assert not port_bn.tile_fits_fly(1, 64, cin, cmid, cout, proj)    # 3 x 66 halo pixels > 192
    assert (cin, cmid, cout, proj) in port_bn.INSTANCES and not port_bn.streams_w2(
        cin, cmid, cout, proj)
    assert port_bn.smem_bytes(96, 48, 96, 8, 16, False) == 165248
    assert port_bn.smem_bytes(48, 48, 96, 8, 16, True) == 183296
    # a width without an instance runs the general kernel, which streams its
    # weights: the 256-wide block gets its tile; a block whose a2 and a3 of one
    # row of 16 pixels do not fit raises
    th, tw = port_bn.choose_tile(1, 8, 16, 256, 128, 256, False)
    assert port_bn.smem_bytes(256, 128, 256, th, tw, False) <= port_bn.MAX_SMEM
    with pytest.raises(ValueError):
        port_bn.choose_tile(1, 8, 16, 2048, 1024, 2048, False)


def test_streamed_w2_budget_numbers():
    # the 128-wide blocks: the fly design (w1, w3 and wp resident as hi and
    # lo, two whole taps of w2) does not fit an 8x16 tile, so they run
    # csrc/bottleneck_128.cu: the vectors, w1 (and a projecting block's w3)
    # resident as hi and lo, a ring of 3-6 chunks of 16 KB for w2 and w3 or
    # wp, and one a2 halo tile at 64 values a pixel
    for block in ((128, 64, 128, False), (64, 64, 128, True)):
        assert block in port_bn.INSTANCES and port_bn.streams_w2(*block)
        assert not port_bn.streams_w2(*block, "bfloat16")
        assert port_bn._layout_fly(*block[:3], 8, 16, block[3])[0] > port_bn.MAX_SMEM
    assert not any(port_bn.streams_w2(*b) for b in port_bn.INSTANCES[:4])
    assert port_bn.packed_size(128, 64, 128, False) * 4 == 2048 + 8 * (8192 + 8192 + 36864) \
        == 428032
    assert port_bn.packed_size(64, 64, 128, True) * 4 == 1536 + 8 * (4096 + 8192 + 36864 + 8192)
    # 8x16: 128 bytes of barriers, 67,584 resident (99,840 with w3), 6 slots
    # (5), 180 halo pixels
    assert port_bn.smem_bytes(128, 64, 128, 8, 16, False) == 128 + 67584 + 6 * 16384 + 180 * 256 \
        == 212096
    assert port_bn.smem_bytes(64, 64, 128, 8, 16, True) == 128 + 99840 + 5 * 16384 + 180 * 256 \
        == 227968 <= port_bn.MAX_SMEM
    assert port_bn._layout_128(128, 1, 1, False) == (128 + 67584 + 6 * 16384 + 9 * 256, 6)
    assert port_bn._layout_128(64, 2, 16, True)[1] == port_bn.WIDE_STAGES[1]
    assert port_bn.tile_fits_128(8, 16, 128, False) and port_bn.tile_fits_128(8, 16, 64, True)
    assert not port_bn.tile_fits_128(9, 16, 128, False)          # 144 pixels: three row blocks
    assert port_bn.tile_fits_128(10, 12, 64, True)               # 12 x 14 halo: 168 <= 192
    assert not port_bn.tile_fits_128(1, 64, 64, True)            # 3 x 66 halo pixels > 192


H36M_SHAPES = [(8, 192, 192), (8, 96, 96), (8, 48, 48), (8, 24, 24), (8, 12, 12), (8, 6, 6),
               (3, 19, 37), (1, 1, 1)]


@pytest.mark.parametrize("n,h,w", H36M_SHAPES)
@pytest.mark.parametrize("cin,proj", [(128, False), (64, True)])
def test_tile_chooser_at_the_h36m_shapes(n, h, w, cin, proj):
    th, tw = port_bn.choose_tile(n, h, w, cin, 64, 128, proj)
    assert 1 <= th <= h and tw == min(w, 16) and th * tw <= port_bn.RING_TILE_PIXELS
    assert (th + 2) * (tw + 2) <= port_bn.RING_HALO_PIXELS
    assert port_bn.tile_fits_128(th, tw, cin, proj)
    assert port_bn.smem_bytes(cin, 64, 128, th, tw, proj) <= port_bn.MAX_SMEM
    blocks = n * -(-h // th) * -(-w // tw)
    if n * h * w >= 16 * port_bn.NUM_SMS and w >= 8:
        assert blocks >= 0.8 * port_bn.NUM_SMS                    # the card is filled


@pytest.mark.parametrize("cin,proj,raw", [(128, False, False), (64, True, False), (64, True, True)])
def test_wide_packed_layout(cin, proj, raw):
    """The 128-wide float32 layout, unpacked section by section: every
    weight once, hi + lo == w bit for bit, hi a TF32 number (low 13 bits
    clear), every section 16-byte aligned, b3 + bp folded; and every tile
    the chooser gives at the h36m shapes fits one thread block."""
    params, stats = _block_params(np.random.default_rng(cin + raw), cin, 128)   # Cmid 64
    assert ("proj" in params) == proj
    folded = port_bn.fold_bottleneck(params, stats, proj_from_raw=raw)
    assert port_bn.streams_w2(cin, 64, 128, proj)
    packed = port_bn.pack_bottleneck(folded).numpy()
    assert packed.dtype == np.float32 and packed.size == port_bn.packed_size(cin, 64, 128, proj)
    sections = port_bn.sections_128(cin, proj)
    assert sum(b for _, b in sections.values()) == 4 * packed.size
    assert all(at % 16 == 0 and b % 16 == 0 for at, b in sections.values())
    f = {k: v.numpy() for k, v in folded.items() if k != "proj_raw"}
    want = {"s1": f["s1"][0], "t1": f["t1"][0], "b1": f["b1"][0], "b2": f["b2"][0],
            "b3": f["b3"][0] + f["bp"][0] if proj else f["b3"][0]}
    for name, v in want.items():
        at, nbytes = sections[name]
        np.testing.assert_array_equal(packed[at // 4:(at + nbytes) // 4], v)
    mats = {"w1": (f["w1"], "quad"), "w3": (f["w3"], "pair"),
            "w2": (f["w2"].reshape(9 * 64, 64), "pair")}
    if proj:
        mats["wp"] = (f["wp"], "quad")
    assert sorted(mats) == sorted(k for k in sections if k.startswith("w"))
    for name, (w, order) in mats.items():
        at, nbytes = sections[name]
        hi, lo, count = _unpack_tf32(packed[at // 4:(at + nbytes) // 4], *w.shape, order)
        assert (count == 1).all(), name
        assert ((hi.view(np.int32) & 0x1FFF) == 0).all(), name
        np.testing.assert_array_equal(hi + lo, w, err_msg=name)
        np.testing.assert_array_equal(lo, w - hi, err_msg=name)
    for n, h, w in H36M_SHAPES:
        th, tw = port_bn.choose_tile(n, h, w, cin, 64, 128, proj)
        assert port_bn.smem_bytes(cin, 64, 128, th, tw, proj) <= port_bn.MAX_SMEM
