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
