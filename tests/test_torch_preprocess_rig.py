"""The preprocess with the rig registration folded in, vs the JAX package's composition.

Frames are built from the shipped rig template with planted per-camera
shifts (the +-8 wrap, zero and others) and gains (1.05, 0.93 and 1, which
the dead zone snaps to exactly 1).  The port's ``preprocess_frames(x, flip,
shape, shift=(dy, dx), gain=corr)`` must agree within 1e-6 on [0, 1] values
with JAX's ``apply_shift_tc`` -> ``preprocess_frames`` -> ``* gain_correction``
(two float32 matmuls whose sums run in another order in each framework), and
be bit-equal to the port's own unfused composition (the roll, the
preprocess, the multiply: what the pipeline ran before the preprocess took
them in).  In identity mode the TPU kernel's function with the registration
around it is exact against the Pallas kernel.  A pipeline and a cascade with
the registration in the preprocess give bit for bit what they give with the
frames rolled before it and the gain multiplied after it.
"""

import copy
import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_tpu.ops import canonicalize as jax_rig
from deepfly3d_tpu.ops import image as jax_image
from deepfly3d_tpu.ops.pallas import kernels as jax_kernels
from deepfly3d_torch.models.cascade import build_cascade_pipeline
from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.models.inference import infer_batch
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.ops import canonicalize as port_rig
from deepfly3d_torch.ops import geometry as port_geo
from deepfly3d_torch.ops import image as port_image
from deepfly3d_torch.ops import kernels as port_kernels
from deepfly3d_torch.pipeline import build_pipeline

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_geometry_rig import TEMPLATE, _frames_from_template  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DY = [8, -8, 0, 3, -5, 0, 2]
DX = [-8, 8, 0, -4, 6, 1, 0]
GAIN = [1.05, 1.0, 0.93, 1.0, 1.05, 0.93, 1.0]
TINY = dict(num_stacks=1, features=16, depth=2, num_blocks=1, num_classes=19)


@pytest.fixture(scope="module")
def drifted():
    """One frame of 7 cameras with planted shifts and gains, and the port's
    registration of it: (frames (1, C, H, W, 3), dy, dx, corr)."""
    tpl = jax_rig.load_template(TEMPLATE)
    frames = _frames_from_template(tpl, 1, DY, DX, GAIN, seed=3)
    ta = port_rig.prepare(port_rig.load_template(TEMPLATE), "cpu")
    dy, dx, gain = port_rig.estimate_tc(torch.from_numpy(frames), ta)
    np.testing.assert_array_equal(dy.numpy(), DY)
    np.testing.assert_array_equal(dx.numpy(), DX)
    corr = port_rig.gain_correction(gain)
    assert (corr == 1.0).sum() == 3 and (corr != 1.0).sum() == 4
    return frames, dy, dx, gain, corr


def _flip(pattern):
    return np.arange(7) % 2 == (1 if pattern == "odd" else 0)


@pytest.mark.parametrize("out_hw", [(256, 512), (192, 384), (480, 960)])
@pytest.mark.parametrize("pattern", ["odd", "even"])
def test_drifted_frames_match_jax(drifted, out_hw, pattern):
    frames, dy, dx, gain, corr = drifted
    flip = _flip(pattern)
    jframes = jax_rig.apply_shift_tc(jnp.asarray(frames), jnp.asarray(dy.numpy()),
                                     jnp.asarray(dx.numpy()))
    jcorr = jax_rig.gain_correction(jnp.asarray(gain.numpy()), jnp.float32)
    want = jax_image.preprocess_frames(jframes[0], jnp.asarray(flip), out_hw)
    want = np.asarray(want * jcorr[:, None, None, None])
    got = port_image.preprocess_frames(torch.from_numpy(frames[0]), torch.from_numpy(flip),
                                       out_hw, shift=(dy, dx), gain=corr).numpy()
    assert got.shape == want.shape == (7,) + out_hw + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_hw", [(256, 512), (192, 384), (480, 960), (13, 29)])
def test_fused_equals_unfused_composition(drifted, out_hw):
    frames, dy, dx, _, corr = drifted
    flip = torch.from_numpy(_flip("odd"))
    x = torch.from_numpy(frames[0])
    got = port_kernels.preprocess_resize(x, flip, out_hw, shift=(dy, dx), gain=corr)
    rolled = port_rig.apply_shift_tc(torch.from_numpy(frames), dy, dx)[0]
    want = port_image.preprocess_frames(rolled, flip, out_hw) * corr[:, None, None, None]
    assert torch.equal(got, want)
    assert not torch.equal(got, port_image.preprocess_frames(x, flip, out_hw))


@pytest.mark.parametrize("shape", [(4, 12, 20, 3), (3, 37, 50, 3)])
def test_identity_with_registration_equals_pallas(shape):
    """The TPU kernel's function with the roll before it and the gain after."""
    n, h, w, _ = shape
    rng = np.random.default_rng(h)
    frames = rng.integers(0, 256, size=shape, dtype=np.uint8)
    flip = np.arange(n) % 2 == 1
    dy = rng.integers(-h, h, size=n).astype(np.int32)
    dx = rng.integers(-w, w, size=n).astype(np.int32)
    gain = np.where(np.arange(n) % 2, 1.0, rng.uniform(0.9, 1.1, size=n)).astype(np.float32)
    rolled = jax_rig.apply_shift_tc(jnp.asarray(frames)[None], jnp.asarray(dy), jnp.asarray(dx))[0]
    want = np.asarray(jax_kernels.preprocess_u8_pallas(rolled, jnp.asarray(flip))
                      * jnp.asarray(gain)[:, None, None, None])
    args = (torch.from_numpy(frames), torch.from_numpy(flip))
    reg = dict(shift=(torch.from_numpy(dy), torch.from_numpy(dx)), gain=torch.from_numpy(gain))
    np.testing.assert_array_equal(port_kernels.preprocess_u8_plain(*args, **reg).numpy(), want)
    np.testing.assert_array_equal(port_kernels.preprocess_resize(*args, (h, w), **reg).numpy(),
                                  want)


def _bad_registrations():
    n = 3
    dy, dx = torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    gain = torch.ones(n)
    meta = dict(device="meta")
    return {
        "shift_not_a_pair": dict(shift=dy),
        "dy_shape": dict(shift=(torch.zeros(n + 1, dtype=torch.int32), dx)),
        "dx_dtype": dict(shift=(dy, dx.long())),
        "dy_device": dict(shift=(torch.zeros(n, dtype=torch.int32, **meta), dx)),
        "gain_shape": dict(gain=torch.ones(n, 1)),
        "gain_dtype": dict(gain=gain.double()),
        "gain_device": dict(gain=torch.ones(n, **meta)),
        "gain_strided": dict(gain=torch.ones(2 * n)[::2]),
    }


@pytest.mark.parametrize("case", sorted(_bad_registrations()))
def test_wrapper_rejects_bad_registration(case):
    frames = torch.zeros((3, 8, 8, 3), dtype=torch.uint8)
    flip = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        port_kernels.preprocess_resize(frames, flip, (4, 4), **_bad_registrations()[case])


def _tiny_variables(spec, input_shape, seed):
    jspec = jax_hg.HourglassSpec(**TINY)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(jspec, input_shape, jax.random.PRNGKey(seed)))
    return variables, dataclasses.replace(spec, input_shape=input_shape)


def _unfused_registration(pipe):
    """A copy of ``pipe`` that registers as the pipeline did before the
    preprocess took the roll and gain in: ``apply_shift_tc`` on the (T, C)
    frames first, the gain multiplied after the preprocess."""
    ref = copy.copy(pipe)

    def register(frames_u8):
        frames = torch.as_tensor(frames_u8)
        T, C, H, W, _ = frames.shape
        dy, dx, gain = port_rig.estimate_tc(frames, pipe.rig)
        frames = port_rig.apply_shift_tc(frames, dy, dx)
        reg = (dy.repeat(T), dx.repeat(T), port_rig.gain_correction(gain).repeat(T))
        return frames.reshape(T * C, H, W, 3), pipe.flip.repeat(T), reg, (dy, dx), T

    def preprocess(x_u8, flip, shape, dtype, shift=None, gain=None):
        return port_image.preprocess_frames(x_u8, flip, shape, dtype) * gain[:, None, None, None]

    ref._register, ref.preprocess = register, preprocess
    return ref


@pytest.mark.parametrize("path", ["pipeline", "cascade"])
def test_registration_in_preprocess_matches_unfused_pipeline(path):
    tpl = jax_rig.load_template(TEMPLATE)
    frames = _frames_from_template(tpl, 8, DY, DX, GAIN, seed=4)
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = port_geo.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    order = list(range(7))
    spec = HourglassSpec(**TINY)
    if path == "pipeline":
        variables, spec = _tiny_variables(spec, (64, 128), seed=0)
        pipe = build_pipeline(spec, variables, calib, order, device="cpu")
    else:
        student = _tiny_variables(spec, (32, 64), seed=1)
        teacher = _tiny_variables(spec, (64, 128), seed=2)
        pipe = build_cascade_pipeline(*student, *teacher, calib, order, device="cpu")
    got = pipe(frames)
    want = _unfused_registration(pipe)(frames)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if path == "cascade":
        repaired = pipe.last_repaired.clone()
        _unfused_registration(pipe)(frames)
        assert torch.equal(repaired, pipe.last_repaired)


def test_infer_batch_gain_matches_multiply():
    variables, spec = _tiny_variables(HourglassSpec(**TINY), (32, 64), seed=5)
    net = FoldedHourglass(fold_hourglass(variables, spec), spec).eval()
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, size=(4, 48, 96, 3), dtype=np.uint8))
    flip = torch.tensor([False, True, False, True])
    gain = torch.tensor([1.0, 0.95, 1.04, 1.0])
    pts, conf = infer_batch(net, images, flip, (32, 64), gain)
    x = port_image.preprocess_frames(images, flip, (32, 64)) * gain[:, None, None, None]
    want_pts, want_conf = port_kernels.decode_heatmaps_plain(net(x)[-1])
    assert torch.equal(pts, want_pts) and torch.equal(conf, want_conf)


@pytest.mark.parametrize("in_hw,out_hw,rows,stage_rows", [
    ((480, 960), (256, 512), 3, 8), ((480, 960), (192, 384), 2, 7),
    ((480, 960), (480, 960), 8, 8), ((37, 50), (13, 29), 1, 6)])
def test_preprocess_plan(in_hw, out_hw, rows, stage_rows):
    """The kernel's band height: the most output rows whose input rows stay
    within the budget; ``stage_rows`` is what the widest band reads."""
    budget = port_kernels.PREPROCESS_STAGE_ROWS
    plan = port_kernels.preprocess_plan(*in_hw, 3, *out_hw, budget)
    assert plan[:2] == (rows, stage_rows) and plan[2] <= 227 * 1024
    starts, wh = port_image.resize_taps(in_hw[0], out_hw[0], 1.0 / 255.0)
    reads = [starts[min(o + rows, out_hw[0]) - 1] + wh.shape[1] - starts[o]
             for o in range(0, out_hw[0], rows)]
    assert max(reads) == stage_rows <= budget or rows == 1
    taller = [starts[min(o + rows + 1, out_hw[0]) - 1] + wh.shape[1] - starts[o]
              for o in range(0, out_hw[0], rows + 1)]
    assert max(taller) > budget or rows == out_hw[0]


def test_preprocess_plan_rejects_rows_beyond_shared_memory():
    with pytest.raises(ValueError):
        port_kernels.preprocess_plan(480, 960, 3, 8, 16, port_kernels.PREPROCESS_STAGE_ROWS)


# the run design's shapes: the h36m path, the fly paths at their batches,
# identity mode and the rows of 150 bytes that the design does not take
RUN_SHAPES = [(8, (1000, 1000), (384, 384)), (56, (480, 960), (256, 512)),
              (56, (480, 960), (192, 384)), (7, (480, 960), (256, 512)),
              (4, (480, 960), (480, 960)), (3, (37, 50), (13, 29))]


def _run_schedule(n, h_in, h_out, grid, bf16):
    """The H pass of ``csrc/preprocess.cu``'s run design, walked as its kernel
    walks it: per block, the producer's rows and, per run, the consumers'
    rows with the weights they add to each output row of the run.
    -> ({(image, output row): [(input row, weight), ...]}, [(produced, consumed)])."""
    starts, weights = port_kernels._taps(h_in, h_out, 1.0 / 255.0, bf16)
    kh = weights.shape[1]
    ends, steps = port_kernels.preprocess_steps(h_in, h_out, bf16)
    fed, streams = {}, []
    for runs in port_kernels.preprocess_runs(n, h_out, grid):
        produced, consumed = [], []
        for img, oa, ob in runs:
            produced += range(starts[oa], ends[ob] + 1)

            def consume(v, w, first):
                consumed.append(v)
                for j in range(3):
                    if first + j < ob:
                        fed.setdefault((img, first + j), []).append((v, float(w[j])))

            lo, e_prev = starts[oa], ends[oa]
            for v in range(lo, e_prev + 1):                    # the run's first rows
                consume(v, [weights[oa + j, v - starts[oa + j]]
                            if oa + j < h_out and 0 <= v - starts[oa + j] < kh else 0.0
                            for j in range(3)], oa)
            e_cur = ends[oa + 1]
            for o in range(oa, ob):                            # the steps
                for r in range(3):
                    v = e_prev + 1 + r
                    if v > e_cur:
                        break
                    if v >= lo:
                        consume(v, steps[o, r, :3], o)
                e_prev, e_cur = e_cur, ends[min(o + 2, h_out)]
        streams.append((produced, consumed))
    return fed, streams


@pytest.mark.parametrize("n,in_hw,out_hw", RUN_SHAPES)
@pytest.mark.parametrize("sms", [132, 5])
def test_preprocess_run_plan_covers_every_row(n, in_hw, out_hw, sms):
    """The run design's plan: every output row of every image in exactly one
    run of one block, a block's runs contiguous and each of one image; a ring
    that holds the input rows of a whole output row; shared memory within
    227 KB and as the kernel's layout counts it."""
    plan = port_kernels.preprocess_run_plan(n, *in_hw, 3, *out_hw, None, sms)
    assert plan.grid == min(plan.per_sm * sms, n * out_hw[0])
    rows = [(img, o) for runs in port_kernels.preprocess_runs(n, out_hw[0], plan.grid)
            for img, oa, ob in runs for o in range(oa, ob)]
    assert rows == [(img, o) for img in range(n) for o in range(out_hw[0])]
    kh = port_image.resize_taps(in_hw[0], out_hw[0])[1].shape[1]
    kw = port_image.resize_taps(in_hw[1], out_hw[1])[1].shape[1]
    assert plan.ring_rows >= kh and plan.hslots >= 1
    r4 = lambda v: -(-v // 4) * 4
    slot = -(-(max(in_hw[1] * 3, 3072) + 12) // 16) * 16
    want = (16 * (plan.ring_rows + plan.hslots) + 4 * r4(out_hw[1] * kw) + 4 * r4(out_hw[1])
            + 4 * plan.hslots * (in_hw[1] * 3 + r4(3 * (kw - 1))) + plan.ring_rows * slot)
    assert plan.smem == want == port_kernels.preprocess_run_smem(
        in_hw[1], 3, out_hw[1], kw, plan.ring_rows, plan.hslots) <= 227 * 1024
    assert plan.per_sm == (2 if 2 * (plan.smem + 1024) <= 228 * 1024 else 1)
    if in_hw == (1000, 1000):
        assert plan.smem == 80800 and plan.per_sm == 2


@pytest.mark.parametrize("h_in,h_out", [(1000, 384), (480, 256), (480, 192), (480, 480),
                                        (37, 13), (50, 29)])
@pytest.mark.parametrize("bf16", [False, True])
def test_preprocess_run_schedule_feeds_every_tap_in_order(h_in, h_out, bf16):
    """Walked as the kernel walks it (two images, blocks whose shares cross
    image boundaries), the H pass streams each run's input rows once, in the
    order the producer copies them, and adds to every output row exactly its
    taps in increasing k (and otherwise only zero weights, which add +0 to a
    sum that is >= +0): the sums are the band design's, bit for bit."""
    starts, weights = port_kernels._taps(h_in, h_out, 1.0 / 255.0, bf16)
    for grid in (1, 7, 2 * h_out - 1):
        fed, streams = _run_schedule(2, h_in, h_out, grid, bf16)
        for produced, consumed in streams:
            assert consumed == produced
        for img in range(2):
            for o in range(h_out):
                got = [(v, w) for v, w in fed[(img, o)] if w != 0.0]
                want = [(int(starts[o]) + k, float(weights[o, k]))
                        for k in range(weights.shape[1]) if weights[o, k] != 0.0]
                assert got == want, (grid, img, o)
                assert all(w >= 0.0 for _, w in fed[(img, o)])


def test_preprocess_steps_only_where_three_rows_suffice():
    """A downscale whose steps add more than three input rows (1000 -> 192:
    up to 6) has no step table, and so runs the band design."""
    assert port_kernels.preprocess_steps(1000, 192) is None
    ends, steps = port_kernels.preprocess_steps(1000, 384)
    assert ends.shape == (385,) and steps.shape == (384, 3, 4) and np.diff(ends).max() == 3
    assert port_kernels.preprocess_instance(3, 1000, 192, 11, 11, False, 0, 0) == 0


@pytest.mark.parametrize("in_hw,out_hw,src_off,want", [
    ((1000, 1000), (384, 384), 0, 256 + 6 * 17),            # the h36m path: 6 taps
    ((1000, 1000), (384, 384), 8, 256 + 6 * 17),            # rows 8 bytes off 16
    ((1000, 1000), (384, 384), 1, 0),                       # one byte off: runtime taps
    ((480, 960), (256, 512), 0, 256 + 4 * 17),              # the fly paths
    ((480, 960), (192, 384), 0, 256 + 5 * 17),
    ((480, 960), (480, 960), 0, 256 + 17),                  # identity
    ((1080, 1920), (256, 512), 0, 0),                       # 9 taps: the band design
    ((720, 1280), (384, 640), 0, 0),                        # rows past 3072 bytes
    ((720, 1280), (384, 683), 0, 0),                        # w_out % 4 != 0
    ((37, 50), (13, 29), 0, 0)])                            # rows of 150 bytes
def test_preprocess_instance_by_shape(in_hw, out_hw, src_off, want):
    """``kernels.preprocess_instance``, the mirror of the kernel's
    ``instance()``: which design and taps a call runs, the same for both
    output dtypes."""
    kh = port_image.resize_taps(in_hw[0], out_hw[0])[1].shape[1]
    kw = port_image.resize_taps(in_hw[1], out_hw[1])[1].shape[1]
    for bf16 in (False, True):
        steps = port_kernels.preprocess_steps(in_hw[0], out_hw[0], bf16) is not None
        assert port_kernels.preprocess_instance(3, in_hw[1], out_hw[1], kh, kw, steps,
                                                4096 + src_off, 8192) == want
    assert port_kernels.preprocess_instance_name(want) == (f"run {kh}x{kw}" if want
                                                           else "runtime taps")
