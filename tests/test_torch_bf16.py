"""The bfloat16 serving path: the port against the JAX package's bfloat16 functions, on the CPU.

The JAX package deploys its nets at ``compute_dtype=bfloat16`` (``bench.py``'s
bf16 configurations), optionally with a bfloat16 preprocess
(``preprocess_dtype``).  The port computes the same roundings in its plain
versions (float32 products of bfloat16-valued tensors, each rounding where
JAX casts), which the card's bf16 kernel instances are held to.

* **One block** at every width of ``ops/bottleneck.INSTANCES`` (with
  projection, and with the raw-input projection): ``bottleneck_plain`` at
  bf16 against ``bottleneck_xla`` at bf16 and against ``fused_bottleneck``
  in interpret mode.  At least 99.9% of the elements bit-equal; each other
  element within one bf16 ulp of the block output's largest magnitude.  The
  ulp is taken at that magnitude, not at the element's own: a 1-ulp flip of
  an intermediate (a1, a2, a3) moves the output by an absolute amount, which
  is several ulps of an output that cancels to near zero (JAX's own Pallas
  and XLA blocks differ by 2 ulps of such elements at 96->48->96).  The fold
  gives JAX's bf16 weights bit for bit.
* **Upsample-add** at bf16: bit-equal to ``upsample2x_add_xla``.
* **The bf16 preprocess** on golden frame 0, and with a planted roll and
  gain: bit-equal to JAX's ``preprocess_frames(dtype=bfloat16)`` (and
  ``apply_shift_tc`` before it and ``x * gain.astype(bf16)`` after).
* **The folded forward** of a tiny spec (16 features, depth 2, 2 stacks,
  batch norms moved off their init) at bf16, for every stem and both heads
  (1x1; 3x3 score into a 2x subpixel head), against the flax graph at
  ``compute_dtype=bfloat16``, and for the conv stem with a 1x1 head also
  against JAX's ``fused_apply(fold_hourglass(dtype=bfloat16))``: every
  stack's heatmaps within 6% of their largest magnitude (the JAX package's
  own spread between its two bf16 forwards of the parity checkpoint is
  4.7%).  A random net's heatmaps have no clear peak (the 2% quantile of
  the top-2 margin is 0.01-0.08% of their magnitude, and JAX's own bf16 and
  float32 forwards of the same net pick other cells for 1-20% of the
  image-joints), so peaks and cells are held on trained nets:
* **Golden frame 0** (7 cameras, rig off) through ``build_pipeline`` at bf16
  for every shipped checkpoint (and the p16 checkpoint with a bf16
  preprocess too) and through ``build_cascade_pipeline`` at bf16, against
  JAX's results in ``deepfly3d_torch/data/bf16_t0.npz``: confidences within
  5e-3 (or twice JAX's own bf16-to-float32 difference where that is larger:
  ``chip_smoke.bf16_conf_tol``), the same argmax cells wherever JAX's top-2 heatmap margin exceeds
  2e-3, and no more differing cells in all than 2 + twice the number at
  which JAX's own bf16 and float32 forwards differ (``chip_smoke.
  bf16_cells_check``, which the card's run applies too).  The threshold is
  set from this data: the largest margin at which the port leaves JAX's
  cell is 1.76e-3 (the students), JAX's own two forwards part at up to
  1.0e-3.  It leaves 2.3-5.3% of the image-joints of the parity nets and
  8-56% of the students' below it: trained heatmaps have flat tops, and the
  students' occluded joints have no peak at all (JAX's own bf16 and float32
  forwards pick other cells for 12 and 17 of their 133 image-joints, some
  45-64 cells apart).

Also checked: a dtype name other than float32 and bfloat16 raises, the
trainable network still raises for bf16 (naming its ROADMAP item), and the
float32 forward is unchanged.  ``bf16_t0.npz`` (the chip smoke run's bf16
reference too) holds, per checkpoint, JAX's bf16 cells, confidences and
top-2 margins on golden frame 0 (flax graph; also ``fused_apply`` for the
conv-stem checkpoint with a 1x1 head), the bf16 cascade's, and the JAX
package's golden-contract errors on the CPU in bf16 and float32 (15 golden
frames, rig on; information only: the score-head calibrations absorbed the
TPU's bf16 rounding, which another device does not repeat).  Regenerate it
with

    python tests/test_torch_bf16.py --write
"""

import dataclasses
import functools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepfly3d_tpu  # noqa: E402,F401  (x64 on, as for the float32 references)
from deepfly3d_tpu.models import cascade as jax_cascade  # noqa: E402
from deepfly3d_tpu.models import fused_inference as jax_fused  # noqa: E402
from deepfly3d_tpu.models import hourglass as jax_hg  # noqa: E402
from deepfly3d_tpu.ops import canonicalize as jax_canon  # noqa: E402
from deepfly3d_tpu.ops import geometry as jax_geo  # noqa: E402
from deepfly3d_tpu.ops import image as jax_image  # noqa: E402
from deepfly3d_tpu.ops.pallas import bottleneck as jax_bn  # noqa: E402
from deepfly3d_tpu.ops.pallas import kernels as jax_kernels  # noqa: E402

from deepfly3d_torch.models import fused_inference as port_fused  # noqa: E402
from deepfly3d_torch.models import hourglass as port_hg  # noqa: E402
from deepfly3d_torch.ops import bottleneck as port_bn  # noqa: E402
from deepfly3d_torch.ops import image as port_image  # noqa: E402
from deepfly3d_torch.ops import kernels as port_kernels  # noqa: E402

sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
import chip_smoke as smoke  # noqa: E402
from test_torch_forward import HEADS, INPUT, SPEC_KW, _moved_variables  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights")
GOLDEN_T0 = os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")
REFERENCE = os.path.join(REPO, "deepfly3d_torch", "data", "bf16_t0.npz")
# the bf16 configurations on golden frame 0: checkpoint -> spec fields besides
# compute_dtype (bench.py's p16 "full-bf16" policy: the preprocess in bf16 too)
CONFIGS = smoke.BF16_CONFIGS
STUDENT, TEACHER = "hourglass_fly_fast_nearparity", "hourglass_fly"
GOLDEN_CHECKPOINTS = ("hourglass_fly_tpu", "hourglass_fly_p16_tpu", "hourglass_fly")
HEATMAP_TOL = smoke.BF16_HEATMAP_TOL      # of the heatmaps' largest magnitude


def _bf16(a) -> np.ndarray:
    """A bfloat16 JAX array as float32 numpy (exact)."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _to_port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------------ blocks


def _seeded_block(cin, cmid, cout, proj, seed):
    """``chip_smoke.seeded_block``'s weights (without the projection where the
    block has none) and a seeded input (2, 16, 32, Cin)."""
    params, stats = smoke.seeded_block(np, cin, cmid, cout)
    if not proj:
        params.pop("proj")
    x = np.random.default_rng(seed).standard_normal((2, 16, 32, cin)).astype(np.float32)
    return params, stats, x


def _xla_raw(x, folded):
    """``bottleneck_xla`` with the raw-input projection: the skip projects x."""
    cdtype = x.dtype
    a1 = jnp.maximum(x * folded["s1"][0] + folded["t1"][0], 0).astype(cdtype)
    a2 = jnp.maximum(jax_bn._dotf32(a1, folded["w1"]) + folded["b1"][0], 0).astype(cdtype)
    w2 = folded["w2"].reshape(3, 3, *folded["w2"].shape[1:])
    z2 = jax.lax.conv_general_dilated(
        a2, w2, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + folded["b2"][0]
    a3 = jnp.maximum(z2, 0).astype(cdtype)
    z3 = jax_bn._dotf32(a3, folded["w3"]) + folded["b3"][0]
    return (z3 + jax_bn._dotf32(x, folded["wp"]) + folded["bp"][0]).astype(cdtype)


def _assert_close_bf16(got: np.ndarray, want: np.ndarray, what: str):
    """>= 99.9% bit-equal; the rest within one bf16 ulp of the largest magnitude."""
    assert got.shape == want.shape
    differ = got != want
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    worst = float(np.abs(got - want).max())
    assert differ.mean() <= 1e-3, f"{what}: {differ.mean():.2e} of the elements differ"
    assert worst <= ulp, f"{what}: max abs diff {worst} > one bf16 ulp ({ulp})"


BLOCKS = [(*b, False) for b in port_bn.INSTANCES] + [(*b, True) for b in port_bn.INSTANCES if b[3]]


@pytest.mark.parametrize("cin,cmid,cout,proj,raw", BLOCKS)
def test_block_matches_jax(cin, cmid, cout, proj, raw):
    params, stats, x = _seeded_block(cin, cmid, cout, proj, seed=cin + cmid + raw)
    jf = jax_bn.fold_bottleneck(params, stats, dtype=jnp.bfloat16)
    pf = port_bn.fold_bottleneck(params, stats, proj_from_raw=raw, dtype="bfloat16")
    for k, v in jf.items():
        assert pf[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32), k
        np.testing.assert_array_equal(pf[k].float().numpy(), _bf16(v), err_msg=k)
    xj = jnp.asarray(x, jnp.bfloat16)
    got = port_bn.fused_bottleneck(_to_port(_bf16(xj)), port_bn.add_packed(pf))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 32, cout)
    got = got.float().numpy()
    if raw:
        _assert_close_bf16(got, _bf16(_xla_raw(xj, jf)), "vs bottleneck_xla (raw projection)")
        return
    _assert_close_bf16(got, _bf16(jax_bn.bottleneck_xla(xj, jf)), "vs bottleneck_xla")
    _assert_close_bf16(got, _bf16(jax_bn.fused_bottleneck(xj, jf, interpret=True)),
                       "vs fused_bottleneck (interpret)")


def test_packed_bf16_buffer_layout():
    """The bf16 weight buffer: s1 and t1 as bf16 and the biases as float32
    first, bp kept apart from b3, then the weights as bf16 in wgmma's K-major
    core-matrix order (per k step of 16: column groups of 8, k halves, 8
    columns, 8 values), w1's channels permuted so that lane column t's k slots
    (2t, 2t+1, 2t+8, 2t+9) are channels 4t ... 4t+3, w2 and w3 in plain order."""
    params, stats, _ = _seeded_block(48, 48, 96, True, seed=1)
    f = port_bn.fold_bottleneck(params, stats, dtype="bfloat16")
    packed = port_bn.pack_bottleneck(f)
    assert packed.dtype == torch.uint8
    assert packed.numel() == port_bn.packed_size(48, 48, 96, True, "bfloat16")
    sec = port_bn.bf16_sections(48, 48, 96, True)

    def part(name, dtype):
        at, nbytes = sec[name]
        return packed[at:at + nbytes].view(dtype).float().numpy()

    np.testing.assert_array_equal(part("s1", torch.bfloat16), f["s1"][0].float().numpy())
    np.testing.assert_array_equal(part("t1", torch.bfloat16), f["t1"][0].float().numpy())
    np.testing.assert_array_equal(part("b3", torch.float32), f["b3"][0].numpy())
    np.testing.assert_array_equal(part("bp", torch.float32), f["bp"][0].numpy())
    # w1: value j of column c of k half kc of column group cg of k step ks holds
    # k slot 8kc + j, which lane column t = j // 2 reads as channel 4t + j % 2 + 2kc
    w1 = f["w1"].float().numpy()
    core = part("w1", torch.bfloat16).reshape(3, 6, 2, 8, 8)
    for ks, cg, kc, c, j in ((0, 0, 0, 0, 0), (2, 5, 1, 7, 7), (1, 3, 0, 2, 5), (1, 2, 1, 6, 2)):
        assert core[ks, cg, kc, c, j] == w1[16 * ks + 4 * (j // 2) + j % 2 + 2 * kc, 8 * cg + c]
    # w3: plain order, k slot 8kc + j is row 16ks + 8kc + j
    w3 = f["w3"].float().numpy()
    core = part("w3", torch.bfloat16).reshape(3, 12, 2, 8, 8)
    for ks, cg, kc, c, j in ((0, 0, 0, 0, 0), (2, 11, 1, 7, 7), (1, 7, 0, 1, 3)):
        assert core[ks, cg, kc, c, j] == w3[16 * ks + 8 * kc + j, 8 * cg + c]
    # shared memory: 128 bytes of mbarriers, the packed bytes (to 128), four x
    # halo slots of 10 x 18 pixels x 48 channels and two a2 buffers of 48
    # channels x 232 rows (the 3x3's 192 rows on the halo pitch 18, + 2 x 18 + 2,
    # to 8)
    assert port_bn.smem_bytes(48, 48, 96, 8, 16, True, "bfloat16") == \
        -(-(128 + packed.numel()) // 128) * 128 + 4 * 10 * 18 * 48 * 2 + 2 * 232 * 48 * 2
    # every width fits resident at bf16, with at least two slots at the 4x16 tile
    for cin, cmid, cout, proj in port_bn.INSTANCES:
        assert not port_bn.streams_w2(cin, cmid, cout, proj, "bfloat16")
        assert port_bn.smem_bytes(cin, cmid, cout, 4, 16, proj, "bfloat16") <= port_bn.MAX_SMEM
    assert port_bn.choose_tile(56, 64, 128, 96, 48, 96, False, "bfloat16") == (10, 16)


# (N, H, W) of the three bf16 paths (conv_bf16 and p16_bf16 at 56 images and
# the cascade's teacher at 7: 128x256 ... 2x4; the cascade's student: 48x96
# ... 3x6) and of the h36m network at its batch of 8
BF16_PATH_SHAPES = ([(n, h, 2 * h) for n in (56, 7) for h in (128, 64, 32, 16, 8, 4, 2)]
                    + [(56, h, 2 * h) for h in (48, 24, 12, 6, 3)]
                    + [(8, h, h) for h in (192, 96, 48, 24, 12, 6)])


@pytest.mark.parametrize("cin,cmid,cout,proj", port_bn.INSTANCES)
def test_bf16_packed_sections_and_tiles(cin, cmid, cout, proj):
    """Every bf16 instance width: the packed buffer unpacks to each folded
    weight and vector exactly once (its sections tile the buffer), every
    section starts 16-byte aligned (the kernel bulk-copies them), and every
    tile that ``choose_tile`` gives at the bf16 paths' shapes fits: the
    kernel's pixel and halo limits, and shared memory with two ring slots."""
    params, stats, _ = _seeded_block(cin, cmid, cout, proj, seed=cin + cmid)
    f = port_bn.fold_bottleneck(params, stats, dtype="bfloat16")
    packed = port_bn.pack_bottleneck(f)
    sec = port_bn.bf16_sections(cin, cmid, cout, proj)
    assert sum(n for _, n in sec.values()) == packed.numel()
    at = 0
    for name, (off, nbytes) in sec.items():
        assert off == at and off % 16 == 0, name
        at += nbytes

    def unpack(name, k, n, permuted):
        off, nbytes = sec[name]
        core = packed[off:off + nbytes].view(torch.bfloat16).float().numpy()
        core = core.reshape(k // 16, n // 8, 2, 8, 8)                 # (ks, cg, kc, c, j)
        w = np.full((k, n), np.nan, np.float32)
        ks, cg, kc, c, j = np.meshgrid(*map(np.arange, core.shape), indexing="ij")
        row = 16 * ks + (4 * (j // 2) + j % 2 + 2 * kc if permuted else 8 * kc + j)
        assert np.isnan(w[row, 8 * cg + c]).all()                      # each weight once
        w[row, 8 * cg + c] = core
        return w

    want = {k: v.float().numpy() for k, v in f.items()}
    np.testing.assert_array_equal(unpack("w1", cin, cmid, True), want["w1"])
    np.testing.assert_array_equal(unpack("w2", 9 * cmid, cmid, False),
                                  want["w2"].reshape(9 * cmid, cmid))
    np.testing.assert_array_equal(unpack("w3", cmid, cout, False), want["w3"])
    if proj:
        np.testing.assert_array_equal(unpack("wp", cin, cout, True), want["wp"])
    for name in ("s1", "t1", "b1", "b2", "b3") + (("bp",) if proj else ()):
        off, nbytes = sec[name]
        dtype = torch.bfloat16 if name in ("s1", "t1") else torch.float32
        np.testing.assert_array_equal(packed[off:off + nbytes].view(dtype).float().numpy(),
                                      want[name][0], err_msg=name)
    for n, h, w in BF16_PATH_SHAPES:
        th, tw = port_bn.choose_tile(n, h, w, cin, cmid, cout, proj, "bfloat16")
        assert 1 <= th <= h and tw == min(w, port_bn.TILE_MAX_WIDTH)
        assert port_bn.bf16_tile_fits(th, tw, cin, cmid, cout, proj)
        assert port_bn.smem_bytes(cin, cmid, cout, th, tw, proj, "bfloat16") <= port_bn.MAX_SMEM
        assert port_bn._bf16_layout(cin, cmid, cout, th, tw, proj)[1] >= 2


def test_block_dtype_mismatch_raises():
    params, stats, x = _seeded_block(64, 32, 64, False, seed=0)
    f16 = port_bn.fold_bottleneck(params, stats, dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype it was folded for"):
        port_bn.fused_bottleneck(torch.from_numpy(x), f16)
    with pytest.raises(ValueError, match="compute dtype"):
        port_bn.fold_bottleneck(params, stats, dtype="float16")


# ---------------------------------------------------------- upsample-add


def test_upsample_add_bit_equal():
    rng = np.random.default_rng(3)
    inner = jnp.asarray(rng.standard_normal((2, 4, 8, 64)), jnp.bfloat16)
    skip = jnp.asarray(rng.standard_normal((2, 8, 16, 64)) * 30.0, jnp.bfloat16)
    want = _bf16(jax_kernels.upsample2x_add_xla(inner, skip))
    got = port_kernels.upsample2x_add(_to_port(_bf16(inner)), _to_port(_bf16(skip)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError, match="share one of"):
        port_kernels.upsample2x_add(_to_port(_bf16(inner)), torch.zeros((2, 8, 16, 64)))


# ------------------------------------------------------------- preprocess


@functools.lru_cache(maxsize=None)
def _frame0():
    with np.load(GOLDEN_T0) as z:
        frames, order = z["frames"], z["camera_ordering"]
    flip = np.zeros(7, bool)
    flip[order[4:]] = True
    return frames, flip, order


@pytest.mark.parametrize("out_shape", [(256, 512), (192, 384)])
def test_preprocess_golden_frame0_bit_equal(out_shape):
    frames, flip, _ = _frame0()
    want = _bf16(jax_image.preprocess_frames(jnp.asarray(frames), jnp.asarray(flip), out_shape,
                                             jnp.bfloat16))
    got = port_image.preprocess_frames(torch.from_numpy(frames), torch.from_numpy(flip),
                                       out_shape, "bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_preprocess_shift_and_gain_bit_equal():
    """The rig registration's roll and gain around it, as the pipelines apply them."""
    frames, flip, _ = _frame0()
    dy = np.array([3, -5, 0, 8, -2, 6, -8], np.int32)
    dx = np.array([-4, 7, 2, 0, -8, 5, 1], np.int32)
    gain = np.array([1.0, 1.06, 0.97, 1.0, 1.0312, 0.951, 1.0], np.float32)
    rolled = jax_canon.apply_shift_tc(jnp.asarray(frames)[None], jnp.asarray(dy),
                                      jnp.asarray(dx))[0]
    x = jax_image.preprocess_frames(rolled, jnp.asarray(flip), (256, 512), jnp.bfloat16)
    want = _bf16(x * jnp.asarray(gain)[:, None, None, None].astype(x.dtype))
    got = port_image.preprocess_frames(
        torch.from_numpy(frames), torch.from_numpy(flip), (256, 512), "bfloat16",
        shift=(torch.from_numpy(dy), torch.from_numpy(dx)), gain=torch.from_numpy(gain))
    np.testing.assert_array_equal(got.float().numpy(), want)


# --------------------------------------------------------- tiny forward


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("stem", ["conv", "patchify", "patch8", "patch16"])
def test_tiny_forward_within_jax_spread(stem, head):
    kw = dict(SPEC_KW, stem=stem, **HEADS[head])
    jspec = jax_hg.HourglassSpec(**kw, compute_dtype=jnp.bfloat16)
    variables, rng = _moved_variables(jspec, INPUT, seed=len(stem) + len(head))
    x = rng.uniform(size=(2,) + INPUT + (3,)).astype(np.float32)
    refs = {"flax": np.asarray(jax_hg.HourglassNet(jspec).apply(variables, jnp.asarray(x),
                                                                  train=False))}
    if stem == "conv" and head == "1x1":
        refs["fused_apply"] = np.asarray(jax_fused.fused_apply(
            jax_fused.fold_hourglass(variables, jspec, dtype=jnp.bfloat16), jspec,
            jnp.asarray(x)))
    pspec = port_hg.HourglassSpec(**kw, compute_dtype="bfloat16")
    net = port_fused.FoldedHourglass(port_fused.fold_hourglass(variables, pspec), pspec)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    for name, want in refs.items():
        assert got.shape == want.shape and got.shape[:2] == (2, 2)
        for s in range(2):
            err = np.abs(got[s] - want[s]).max() / np.abs(want[s]).max()
            assert err <= HEATMAP_TOL, f"{name} stack {s}: {err:.4f} of the magnitude"


def test_tiny_forward_carries_bf16_between_layers():
    """Blocks and merges see bfloat16 tensors in a bf16 net, float32 in a
    float32 net, whose forward equals JAX's fused_apply as before."""
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables, rng = _moved_variables(spec, INPUT, seed=0)
    x = rng.uniform(size=(1,) + INPUT + (3,)).astype(np.float32)
    for dtype, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        pspec = port_hg.HourglassSpec(**SPEC_KW, compute_dtype=dtype)
        net = port_fused.FoldedHourglass(port_fused.fold_hourglass(variables, pspec), pspec)
        seen = set()
        block, merge = net.block_fn, net.merge_fn
        net.block_fn = lambda t, f: (seen.add(t.dtype), block(t, f))[1]
        net.merge_fn = lambda a, b: (seen.add(a.dtype), seen.add(b.dtype), merge(a, b))[2]
        with torch.no_grad():
            out = net(torch.from_numpy(x)).numpy()
        assert seen == {want}
    fused = np.asarray(jax_fused.fused_apply(jax_fused.fold_hourglass(variables, spec), spec,
                                             jnp.asarray(x)))
    np.testing.assert_allclose(out, fused, atol=1e-5, rtol=0)


def test_other_dtype_names_raise():
    spec = port_hg.HourglassSpec(**SPEC_KW)
    for field in (dict(compute_dtype="float16"), dict(preprocess_dtype="float16")):
        with pytest.raises(ValueError, match="fold_hourglass does not cover"):
            port_fused.check_foldable(dataclasses.replace(spec, **field))
    port_fused.check_foldable(dataclasses.replace(spec, compute_dtype="bfloat16",
                                                  preprocess_dtype="bfloat16"))
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="preprocess dtype"):
        port_image.preprocess_frames(frames, torch.zeros(1, dtype=torch.bool), (4, 4), "float16")
    # the trainable network takes bfloat16 (tests/test_torch_train_bf16.py), not float16
    assert port_hg.HourglassNet(dataclasses.replace(spec, compute_dtype="bfloat16")).spec \
        .compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="float16"):
        port_hg.HourglassNet(dataclasses.replace(spec, compute_dtype="float16"))


# ------------------------------------------------------ golden frame 0


def _calib():
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        return jax_geo.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)


def _checkpoint(key):
    return os.path.join(WEIGHTS, key.split("+")[0] + ".npz")


def _jax_frame0(key, fused=False, dtype=jnp.bfloat16):
    """JAX's net on golden frame 0 as its pipelines run it: (cells, conf,
    top-2 margin), each (7, 19)."""
    frames, flip, _ = _frame0()
    variables, spec = jax_hg.load_weights(_checkpoint(key))
    spec = dataclasses.replace(spec, compute_dtype=dtype, **CONFIGS[key])
    x = jax_image.preprocess_frames(jnp.asarray(frames), jnp.asarray(flip),
                                    tuple(spec.input_shape or (256, 512)),
                                    jnp.dtype(spec.preprocess_dtype).type)
    if fused:
        hm = jax_fused.fused_apply(jax_fused.fold_hourglass(variables, spec, dtype=dtype),
                                   spec, x)
    else:
        hm = jax_hg.HourglassNet(spec).apply(variables, x, train=False)
    return smoke.decode_np(np, np.asarray(hm[-1]))


def _jax_cascade_frame0():
    frames, _, order = _frame0()
    (sv, ss), (tv, ts) = (jax_hg.load_weights(_checkpoint(k)) for k in (STUDENT, TEACHER))
    ss, ts = (dataclasses.replace(s, compute_dtype=jnp.bfloat16) for s in (ss, ts))
    pipe = jax_cascade.build_cascade_pipeline(sv, ss, tv, ts, _calib(), order,
                                              jax_cascade.CascadeConfig(), rig=None)
    _, p38, conf = pipe(frames[None])
    return np.asarray(p38), np.asarray(conf)


def _golden_errors():
    """The JAX package's golden-contract errors on the CPU, 15 golden frames,
    rig on, bf16 and float32 (``bench.build_pipeline``, flax graph)."""
    from test_torch_pipeline import _import_bench

    bench = _import_bench()
    frames, golden = bench.load_golden_frames()
    out = {}
    for key in GOLDEN_CHECKPOINTS:
        variables, spec = jax_hg.load_weights(_checkpoint(key))
        for dtype in ("bfloat16", "float32"):
            s = dataclasses.replace(spec, compute_dtype=getattr(jnp, dtype))
            pipe = bench.build_pipeline(s, variables, _calib(), golden["camera_ordering"],
                                        tuple(s.input_shape or (256, 512)), rig="auto")
            _, p38, conf = pipe(frames)
            out[f"golden/{key}/{dtype}"] = np.array(
                [np.abs(np.asarray(p38) - golden["points2d"]).max(),
                 np.abs(np.asarray(conf) - golden["heatmap_confidence"]).max()], np.float64)
    return out


def bf16_t0_reference():
    out = {}
    for key in CONFIGS:
        for kind in ("flax", "fused") if key == "hourglass_fly" else ("flax",):
            cells, conf, margin = _jax_frame0(key, fused=kind == "fused")
            out.update({f"{key}/{kind}/cells": cells, f"{key}/{kind}/conf": conf,
                        f"{key}/{kind}/margin": margin})
        # JAX's own spread: its float32 forward's cells and confidences
        out[f"{key}/flax/f32_cells"], out[f"{key}/flax/f32_conf"], _ = _jax_frame0(
            key, dtype=jnp.float32)
    out["cascade/p38"], out["cascade/conf"] = _jax_cascade_frame0()
    out.update(_golden_errors())
    return out


@pytest.fixture(scope="module")
def committed():
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files}


def test_committed_reference_is_current(committed):
    """The reference's keys, and its conv-stem entries recomputed by JAX."""
    want = {f"{k}/flax/{a}" for k in CONFIGS
            for a in ("cells", "conf", "margin", "f32_cells", "f32_conf")}
    want |= {f"hourglass_fly/fused/{a}" for a in ("cells", "conf", "margin")}
    want |= {"cascade/p38", "cascade/conf"}
    want |= {f"golden/{k}/{d}" for k in GOLDEN_CHECKPOINTS for d in ("bfloat16", "float32")}
    assert set(committed) == want
    for got, name in zip(_jax_frame0("hourglass_fly", fused=True), ("cells", "conf", "margin")):
        np.testing.assert_array_equal(committed[f"hourglass_fly/fused/{name}"], got)
    assert sum(a.nbytes for a in committed.values()) < 64 * 1024       # no heatmaps


def _port_pipeline(key, frames, order, cascade=False):
    from deepfly3d_torch.models.cascade import build_cascade_pipeline
    from deepfly3d_torch.pipeline import build_pipeline

    def load(k):
        variables, spec = port_hg.load_weights(_checkpoint(k))
        return variables, dataclasses.replace(spec, compute_dtype="bfloat16",
                                              **CONFIGS.get(k, {}))

    if cascade:
        pipe = build_cascade_pipeline(*load(STUDENT), *load(TEACHER), _calib(), order,
                                      rig=None, device="cpu")
    else:
        pipe = build_pipeline(*reversed(load(key)), _calib(), order, rig=None, device="cpu")
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    _, p38, conf = pipe(frames[None])
    return pipe, p38.numpy(), conf.numpy()


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_golden_frame0_within_jax_spread(committed, key):
    frames, _, order = _frame0()
    pipe, p38, conf = _port_pipeline(key, frames, order)
    assert pipe.net.bf16 and next(iter(pipe.net.blocks.values())).w1.dtype == torch.bfloat16
    kind = "fused" if key == "hourglass_fly" else "flax"
    cells, jconf, margin = (committed[f"{key}/{kind}/{a}"] for a in ("cells", "conf", "margin"))
    spread = int((committed[f"{key}/flax/f32_cells"] != committed[f"{key}/flax/cells"]).sum())
    hw = tuple(v // 4 for v in pipe.input_shape)
    smoke.bf16_cells_check(np, key, p38, smoke.cells_p38(np, cells, order, hw), margin, spread,
                           order)
    err = np.abs(conf[:, 0, :, 0] - jconf).max()
    tol = smoke.bf16_conf_tol(np.abs(committed[f"{key}/flax/f32_conf"]
                                     - committed[f"{key}/flax/conf"]).max())
    assert err <= tol, f"conf {err} > {tol}"


def test_cascade_golden_frame0_within_jax_spread(committed):
    frames, _, order = _frame0()
    pipe, p38, conf = _port_pipeline(None, frames, order, cascade=True)
    assert pipe.net.bf16 and pipe.teacher.bf16
    repaired = int(pipe.last_repaired[0])
    # the repaired image holds the teacher's cells, the others the student's
    margin = committed[f"{STUDENT}/flax/margin"].copy()
    margin[repaired] = committed[f"{TEACHER}/flax/margin"][repaired]
    spread = sum(int((committed[f"{k}/flax/f32_cells"] != committed[f"{k}/flax/cells"]).sum())
                 for k in (STUDENT, TEACHER))
    smoke.bf16_cells_check(np, "cascade", p38, committed["cascade/p38"], margin, spread, order)
    tol = smoke.bf16_conf_tol(max(
        np.abs(committed[f"{k}/flax/f32_conf"] - committed[f"{k}/flax/conf"]).max()
        for k in (STUDENT, TEACHER)))
    assert np.abs(conf - committed["cascade/conf"]).max() <= tol


if __name__ == "__main__" and "--write" in sys.argv:
    ref = bf16_t0_reference()
    np.savez_compressed(REFERENCE, **ref)
    for k in sorted(ref):
        if k.startswith("golden/"):
            print(k, "pts_err / conf_err", ref[k].tolist())
    print("wrote", REFERENCE, os.path.getsize(REFERENCE), "bytes")
