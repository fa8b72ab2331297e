"""The bottleneck at every width the JAX package serves, and the converter's 256-wide checkpoint, on the CPU.

The JAX package's block reads its widths from the weights (``bottleneck_xla``
and the Pallas kernels); the port runs the six widths of
``ops/bottleneck.INSTANCES`` in their compile-time instances and every other
width inside ``ENVELOPE`` in the general instance (``csrc/bottleneck_general
.cu``), whose packed buffer is the general layout.  On the CPU the wrapper
runs the plain version; the card's kernels are held to it in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 13.  Every input is
made with numpy from a seed.

* **(a) One block** at the converter's widths (256->128->256; the raw
  projecting stem block 128->128->256), the README trainer's (16->8->16;
  8->8->16 projecting) and widths that are no multiple of 8 (20->10->20):
  ``bottleneck_plain`` against JAX's ``bottleneck_xla`` at float32 (atol and
  rtol 1e-5: another summation order), the raw projection against the flax
  ``Bottleneck(proj_from_raw=True)``; the kernel's 3xTF32 arithmetic model
  within 1e-5 of the output's magnitude; at bfloat16, >= 99.9% bit-equal to
  JAX's bf16 block and the rest within one bf16 ulp of the largest magnitude
  (``tests/test_torch_bf16.py``'s rule).
* **(b) The general layout**: unpacked (the inverse of the fragment order),
  every weight comes back exactly with zeros in the padding; ``packed_size``
  and ``smem_bytes`` agree with the layout; ``choose_tile`` gives a tile
  within one thread block's 227 KB at every block width of a spec with 8 to
  512 features at the fly path's levels (N = 56) and a batch of 8;
  ``kernel_for`` names the kernel and raises past the envelope.
* **(c) The converted slice at a small size**: a seeded torch state dict under
  the sh8 names (``utils/synthetic.torch_state_dict``) at a converter spec of
  20 features, depth 2, 1 stack, 64x128, converted by both packages'
  ``convert_torch.main`` (the same arrays) and served by the port's
  ``PoseEstimator(device="cpu")`` and JAX's ``PoseEstimator`` (flax graph: the
  JAX fold ignores ``proj_from_raw``) on golden frame 0 of the 7 cameras:
  confidences within 2e-5, the same cells wherever JAX's top-2 margin exceeds
  2e-4, at most 5% of the image-joints excluded (the h36m rule of PERF.md §2).
* **(d) One full-width forward**: the converter's default spec (2 stacks, 256
  features, depth 4, 19 joints, 256x512, ``proj_from_raw``), seeded through
  the same conversion, one image: the port's folded forward against JAX's
  ``HourglassNet.apply`` (both stacks within 1e-4 of the heatmaps' magnitude;
  the last stack's cells where JAX's margin exceeds 2e-4, confidences within
  2e-5).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepfly3d_tpu  # noqa: F401  (x64 on, as for the float32 references)
from deepfly3d_tpu.models import convert_torch as jax_convert
from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_tpu.models.inference import PoseEstimator as JaxEstimator
from deepfly3d_tpu.ops.pallas import bottleneck as jax_bn
from deepfly3d_torch.models import convert_torch as port_convert
from deepfly3d_torch.models import fused_inference as port_fused
from deepfly3d_torch.models import hourglass as port_hg
from deepfly3d_torch.models.inference import PoseEstimator
from deepfly3d_torch.ops import bottleneck as port_bn
from deepfly3d_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
import chip_smoke as smoke  # noqa: E402
from test_torch_bf16 import _assert_close_bf16, _bf16, _to_port, _xla_raw  # noqa: E402

GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
CONF_TOL = 2e-5
MARGIN = 2e-4          # cells are held where JAX's top-2 heatmap margin exceeds this
MAX_EXCLUDED = 0.05    # ... and at most this share of the image-joints is below it


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads: the suite runs 6 workers on the cores, and 8
    threads each oversubscribe them.  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ (a) blocks

# (Cin, Cmid, Cout, projection, raw projection)
BLOCKS = [(256, 128, 256, False, False), (128, 128, 256, True, True), (16, 8, 16, False, False),
          (8, 8, 16, True, False), (20, 10, 20, False, False)]


def _seeded(cin, cmid, cout, proj):
    """``chip_smoke.seeded_block``'s weights as float32 (no projection where
    the block has none) and a seeded input (2, 12, 20, Cin)."""
    params, stats = smoke.seeded_block(np, cin, cmid, cout)
    if not proj:
        params.pop("proj")
    f32 = {k: {n: np.asarray(a, np.float32) for n, a in v.items()} for k, v in params.items()}
    s32 = {k: {n: np.asarray(a, np.float32) for n, a in v.items()} for k, v in stats.items()}
    x = np.random.default_rng(cin + cmid + cout).standard_normal((2, 12, 20, cin))
    return f32, s32, x.astype(np.float32)


@pytest.mark.parametrize("cin,cmid,cout,proj,raw", BLOCKS)
def test_block_matches_jax_float32(cin, cmid, cout, proj, raw):
    params, stats, x = _seeded(cin, cmid, cout, proj)
    assert port_bn.kernel_for(cin, cmid, cout, proj) == "general"
    pf = port_bn.add_packed(port_bn.fold_bottleneck(params, stats, proj_from_raw=raw))
    got = port_bn.fused_bottleneck(torch.from_numpy(x), pf).numpy()
    assert got.shape == x.shape[:3] + (cout,)
    if raw:
        assert cmid == cout // 2                      # the flax block's own widths
        want = np.asarray(jax_hg.Bottleneck(cout, proj_from_raw=True).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    else:
        want = np.asarray(jax_bn.bottleneck_xla(
            jnp.asarray(x), jax_bn.fold_bottleneck(params, stats, dtype=jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    model = port_bn.bottleneck_tf32_model(torch.from_numpy(x), pf).numpy()
    assert np.abs(model - got).max() <= 1e-5 * max(1.0, np.abs(got).max())


@pytest.mark.parametrize("cin,cmid,cout,proj,raw", BLOCKS)
def test_block_matches_jax_bfloat16(cin, cmid, cout, proj, raw):
    params, stats, x = _seeded(cin, cmid, cout, proj)
    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.bfloat16)
    pf = port_bn.add_packed(port_bn.fold_bottleneck(params, stats, raw, "bfloat16"))
    assert pf["packed"].dtype == torch.uint8
    xj = jnp.asarray(x, jnp.bfloat16)
    got = port_bn.fused_bottleneck(_to_port(_bf16(xj)), pf)
    assert got.dtype == torch.bfloat16
    want = _xla_raw(xj, jf) if raw else jax_bn.bottleneck_xla(xj, jf)
    _assert_close_bf16(got.float().numpy(), _bf16(want), f"{(cin, cmid, cout)} vs JAX bf16")


# ------------------------------------------------------- (b) general layout


def _unpack(buf: np.ndarray, k: int, n: int, dtype: str):
    """A (k, n) weight back out of the general layout: per pass of 128
    columns, per k step, the core matrices [column group][k half][column]
    [element] (elements on the channels of ``_k_perm``), at float32 as hi then
    lo.  -> (w, hi or None): w = hi + lo at float32."""
    step = 16 if dtype == "bfloat16" else 8
    e, halves = step // 2, (1 if dtype == "bfloat16" else 2)
    perm = port_bn._k_perm(dtype)
    w = np.full((k, n), np.nan, np.float32)
    hi = np.full((k, n), np.nan, np.float32) if halves == 2 else None
    o = 0
    for n0 in range(0, n, 128):
        nc = min(128, n - n0)
        core = buf[o:o + k * nc * halves].reshape(k // step, halves, nc // 8, 2, 8, e)
        o += k * nc * halves
        for s in range(k // step):
            for kc in range(2):
                for j in range(e):
                    r = step * s + perm[kc, j]
                    vals = core[s, :, :, kc, :, j].reshape(halves, nc)
                    if halves == 2:
                        hi[r, n0:n0 + nc] = vals[0]
                        w[r, n0:n0 + nc] = vals[0] + vals[1]
                    else:
                        w[r, n0:n0 + nc] = vals[0]
    assert o == buf.size
    return w, hi


def test_general_k_order_gives_each_lane_contiguous_channels():
    """Lane column t's k slots of a wgmma A fragment, (t, t+4) at TF32 and (2t,
    2t+1, 2t+8, 2t+9) at bf16, hold channels 2t, 2t+1 / 4t ... 4t+3 of the k
    step, each channel once."""
    for dtype, slots in (("float32", lambda t: [t, t + 4]),
                         ("bfloat16", lambda t: [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9])):
        perm = port_bn._k_perm(dtype)
        e = perm.shape[1]
        flat = perm.reshape(-1)                  # logical k = kc * e + j
        assert sorted(flat) == list(range(2 * e))
        for t in range(4):
            assert [flat[s] for s in slots(t)] == list(range(len(slots(t)) * t,
                                                              len(slots(t)) * (t + 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cmid,cout,proj", [(20, 10, 20, False), (13, 7, 11, True),
                                                (128, 128, 256, True), (200, 136, 330, True)])
def test_general_layout_holds_every_weight_once(cin, cmid, cout, proj, dtype):
    params, stats, _ = _seeded(cin, cmid, cout, proj)
    f = port_bn.fold_bottleneck(params, stats, dtype=dtype)
    packed = port_bn.add_packed(f)["packed"]
    bf16 = dtype == "bfloat16"
    step = 16 if bf16 else 8
    cinp, cmidp = (-(-c // step) * step for c in (cin, cmid))
    cmidn, coutn = (-(-c // 64) * 64 for c in (cmid, cout))
    assert packed.numel() == port_bn.packed_size(cin, cmid, cout, proj, dtype)
    assert (packed.numel() * packed.element_size()) % 16 == 0    # copied in 16-byte pieces
    n_w = cinp * cmidn + 9 * cmidp * cmidn + cmidp * coutn + (cinp * coutn if proj else 0)
    if bf16:
        weights = packed[:2 * n_w].view(torch.bfloat16).float().numpy()
        vectors = packed[2 * n_w:].view(torch.float32).numpy()
    else:                                        # hi and lo of every weight
        weights, vectors = packed[:2 * n_w].numpy(), packed[2 * n_w:].numpy()
    mats = [("w1", cinp, cmidn), ("w2", 9 * cmidp, cmidn), ("w3", cmidp, coutn)]
    if proj:
        mats.append(("wp", cinp, coutn))
    o = 0
    for name, k, n in mats:
        size = k * n * (1 if bf16 else 2)
        # every weight starts 16-byte aligned, and so does each k step of a pass
        assert (o * (2 if bf16 else 4)) % 2048 == 0
        got, hi = _unpack(weights[o:o + size], k, n, dtype)
        o += size
        w = f[name].float().numpy()
        if hi is not None:                   # hi is TF32 and hi + lo == w bit for bit
            assert not (hi.view(np.int32) & 0x1FFF).any()
        if name == "w2":                 # tap-major: each tap's Cmid rows padded to cmidp
            got = got.reshape(9, cmidp, cmidn)
            np.testing.assert_array_equal(got[:, :cmid, :cmid], w)
        else:
            np.testing.assert_array_equal(got[:w.shape[0], :w.shape[1]], w)
        got[tuple(slice(0, s) for s in w.shape)] = 0.0
        assert not got.any(), f"{name}: padding is not zero"
    assert o == weights.size
    o = 0
    for name, width in (("s1", cinp), ("t1", cinp), ("b1", cmidn), ("b2", cmidn), ("b3", coutn),
                        ("bp", coutn)):
        if name == "bp" and not proj:
            continue
        v, want = vectors[o:o + width], f[name][0].float().numpy()
        np.testing.assert_array_equal(v[:want.size], want)
        assert not v[want.size:].any()
        o += width
    assert o == vectors.size


def test_general_shared_memory_budget():
    # the 256-wide block at an 8x16 tile: 128 bytes of mbarriers, the ring
    # (float32: 4 chunks of 4 k8 steps x 128 columns, hi and lo; bf16: 8 of 4
    # k16 steps), a2 on the 180 halo pixels at a pitch of 136 float32 / 144
    # bf16 values, and a3 on the 128 tile pixels over a2's bytes; bf16 takes
    # tiles of up to 256 pixels (two m64 row blocks per warpgroup, chunks of 2
    # k16 steps)
    assert port_bn.smem_bytes(256, 128, 256, 8, 16, False) == \
        128 + 4 * 4 * 2 * 32 * 128 + 180 * 136 * 4 == 229120
    assert port_bn.smem_bytes(256, 128, 256, 8, 16, False, "bfloat16") == \
        128 + 8 * 4 * 32 * 128 + 180 * 144 * 2 == 183040
    assert port_bn.smem_bytes(256, 128, 256, 16, 16, False, "bfloat16") == \
        128 + 65536 + 324 * 144 * 2 <= port_bn.MAX_SMEM
    # Cmid = 10 pads to 16 (pitch 40 float32 values)
    assert port_bn.smem_bytes(20, 10, 20, 1, 16, False) == 128 + 131072 + 54 * 40 * 4
    # Cmid = 256 takes two passes of stage 2, so a3 has bytes of its own: the
    # widest block fits 1x16 at float32 and 4x16 at bf16
    assert port_bn.smem_bytes(512, 256, 512, 1, 16, False) == \
        128 + 131072 + (54 + 16) * 264 * 4 <= port_bn.MAX_SMEM
    assert port_bn.smem_bytes(512, 256, 512, 2, 16, False) > port_bn.MAX_SMEM
    assert port_bn.smem_bytes(512, 256, 512, 4, 16, False, "bfloat16") <= port_bn.MAX_SMEM
    assert port_bn.smem_bytes(512, 256, 512, 5, 16, False, "bfloat16") > port_bn.MAX_SMEM
    assert port_bn.choose_tile(56, 64, 128, 256, 128, 256, False) == (8, 16)
    assert port_bn.choose_tile(56, 64, 128, 512, 256, 512, False) == (1, 16)
    assert port_bn.choose_tile(56, 64, 128, 512, 256, 512, False, "bfloat16")[0] <= 4
    # the packed buffer: float32 holds hi and lo of every weight
    assert port_bn.packed_size(256, 128, 256, False) == \
        2 * (256 * 128 + 9 * 128 * 128 + 128 * 256) + 2 * 256 + 2 * 128 + 256
    assert port_bn.packed_size(256, 128, 256, False, "bfloat16") == \
        2 * (256 * 128 + 9 * 128 * 128 + 128 * 256) + 4 * (2 * 256 + 2 * 128 + 256)
    # the instances keep their own layout, tiles and tables (the fly layout:
    # the vectors, then every weight as hi and lo)
    assert port_bn.packed_size(96, 48, 96, False) * 4 == \
        4 * (2 * 96 + 2 * 48 + 96) + 8 * (96 * 48 + 9 * 48 * 48 + 48 * 96) == 241152
    assert port_bn.kernel_for(96, 48, 96, False) == "instance"
    assert port_bn.kernel_for(96, 48, 96, True) == "general"
    for past in ((513, 256, 512), (512, 257, 512), (512, 256, 513), (0, 8, 8)):
        with pytest.raises(ValueError, match="envelope"):
            port_bn.kernel_for(*past, True)


# the fly path's levels at N = 56 (128x256 is the stem block's) and a batch of 8
TILE_SHAPES = [(n, h, w) for n in (56, 8) for h, w in
               [(128, 256), (64, 128), (32, 64), (16, 32), (8, 16), (4, 8), (2, 4)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_width_of_the_envelope_has_a_tile(dtype):
    """Every block of a spec with 8 to 512 features (F -> F/2 -> F, and the
    stem block F/2 -> F/2 -> F with its projection) gets a tile within one
    thread block's shared memory at every level of the fly path."""
    for feat in range(8, 513, 2):
        for cin, proj in ((feat, False), (feat // 2, True)):
            block = (cin, feat // 2, feat, proj)
            if port_bn.kernel_for(*block) == "instance":
                continue
            for n, h, w in TILE_SHAPES:
                th, tw = port_bn.choose_tile(n, h, w, *block, dtype)
                assert 1 <= th <= h and tw == min(w, 16)
                assert th * tw <= port_bn.GENERAL_TILE_PIXELS[dtype]
                assert port_bn.smem_bytes(*block[:3], th, tw, proj, dtype) <= port_bn.MAX_SMEM


# ------------------------------------------------------- (c) the slice, small


def _convert(tmp_path, seed, spec_kw):
    """A seeded torch checkpoint under the sh8 names at ``spec_kw`` (the
    converter's flags), converted by both packages: -> (port file, JAX file)."""
    arrays = synthetic.random_checkpoint(
        str(tmp_path / "seeded.npz"), seed, spec_kw["stacks"], spec_kw["features"],
        spec_kw["depth"], 19, spec_kw["input"])
    sd = synthetic.torch_state_dict(arrays, spec_kw["stacks"], spec_kw["depth"])
    ckpt = str(tmp_path / "sh8.tar")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    flags = ["--stacks", str(spec_kw["stacks"]), "--features", str(spec_kw["features"]),
             "--depth", str(spec_kw["depth"]), "--input-shape", *map(str, spec_kw["input"])]
    out = {}
    for name, convert in (("port", port_convert), ("jax", jax_convert)):
        out[name] = str(tmp_path / f"{name}.npz")
        assert convert.main([ckpt, out[name]] + flags) == 0
    with np.load(out["port"]) as a, np.load(out["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, v in arrays.items():              # the state dict carried every array
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    return out["port"], out["jax"]


def _frame0():
    with np.load(GOLDEN_T0) as z:
        frames, order = z["frames"], z["camera_ordering"]
    flip = np.zeros(7, bool)
    flip[order[4:]] = True
    return frames, flip


def _margin(hm: np.ndarray) -> np.ndarray:
    """(N, H, W, K) heatmaps -> (N, K) top-2 margins."""
    flat = np.sort(hm.reshape(hm.shape[0], -1, hm.shape[-1]), axis=1)
    return flat[:, -1] - flat[:, -2]


def _hold_cells(got_pts, want_pts, margin):
    decided = margin > MARGIN
    assert (margin <= MARGIN).mean() <= MAX_EXCLUDED
    np.testing.assert_allclose(got_pts[decided], want_pts[decided], atol=smoke.CELL_ATOL, rtol=0)


def test_converted_slice_small_matches_jax(tmp_path):
    spec_kw = {"stacks": 1, "features": 20, "depth": 2, "input": (64, 128)}
    port_file, jax_file = _convert(tmp_path, 7, spec_kw)
    frames, flip = _frame0()
    est = PoseEstimator(port_file, device="cpu")
    assert est.spec.proj_from_raw and est.spec.features == 20 and est.rig is None
    blocks = est.net.blocks
    assert "proj_raw" in blocks["stem_res1"].as_dict()
    assert {port_bn.kernel_for(b["w1"].shape[0], b["w1"].shape[1], b["w3"].shape[1], "wp" in b)
            for b in (blk.as_dict() for blk in blocks.values())} == {"general"}
    pts, conf, _ = est.infer_images(frames, flip, batch_size=7, return_heatmaps=True)
    jpts, jconf, jhm = (np.asarray(a) for a in JaxEstimator(jax_file, fused=False).infer_images(
        frames, flip, batch_size=7, return_heatmaps=True))
    np.testing.assert_allclose(conf, jconf, atol=CONF_TOL, rtol=0)
    _hold_cells(pts, jpts, _margin(jhm))


# --------------------------------------------------- (d) one full-width forward


@functools.lru_cache(maxsize=None)
def _full_width_input():
    return np.random.default_rng(5).uniform(size=(1, 256, 512, 3)).astype(np.float32)


def test_converted_full_width_forward_matches_flax(tmp_path):
    spec_kw = {"stacks": 2, "features": 256, "depth": 4, "input": (256, 512)}
    port_file, _ = _convert(tmp_path, 0, spec_kw)
    variables, spec = port_hg.load_weights(port_file)
    assert spec == port_hg.HourglassSpec(num_stacks=2, features=256, depth=4, num_blocks=1,
                                         num_classes=19, stem="conv", input_shape=(256, 512),
                                         proj_from_raw=True)
    folded = port_fused.fold_hourglass(variables, spec)
    assert len(folded["blocks"]) == 31
    assert sorted({port_bn.kernel_for(b["w1"].shape[0], b["w1"].shape[1], b["w3"].shape[1],
                                      "wp" in b) for b in folded["blocks"].values()}) == ["general"]
    x = _full_width_input()
    with torch.no_grad():
        got = port_fused.FoldedHourglass(folded, spec)(torch.from_numpy(x)).numpy()
    jvars, jspec = jax_hg.load_weights(port_file)
    want = np.asarray(jax_hg.HourglassNet(jspec).apply(jvars, jnp.asarray(x), train=False))
    assert got.shape == want.shape == (2, 1, 64, 128, 19)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    flat_got, flat_want = got[-1].reshape(64 * 128, 19), want[-1].reshape(64 * 128, 19)
    np.testing.assert_allclose(flat_got.max(0), flat_want.max(0), atol=CONF_TOL, rtol=0)
    margin = _margin(want[-1])[0]
    decided = margin > MARGIN
    assert (margin <= MARGIN).mean() <= MAX_EXCLUDED
    np.testing.assert_array_equal(flat_got.argmax(0)[decided], flat_want.argmax(0)[decided])
