"""The port's student + parity-repair cascade vs the JAX package's, on the CPU.

``loo_suspicion`` is held to JAX at rtol 1e-4 on the golden 2D points with
one planted wrong cell, which must rank first in both.  The top-R choice
must break ties like ``jax.lax.top_k`` (lower index first): the middle
camera's images all score exactly 0.

The whole cascade (student ``hourglass_fly_fast_nearparity.npz`` at
192x384, teacher ``hourglass_fly.npz`` at 256x512, both float32, rig
registration on) runs the 15 golden frames through the port's
``build_cascade_pipeline(device="cpu")`` and JAX's
``cascade.build_cascade_pipeline``: the same repaired images, the same p38,
conf within 2e-5 and points3d within rtol 1e-4.  JAX's repaired images are
the top R of JAX's ``loo_suspicion`` on the JAX student's points.  "The
same p38" is the same argmax cells: see ``test_cascade_same_argmax_cells``.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepfly3d_tpu  # noqa: F401  (x64 on before bench.py is imported)
from deepfly3d_tpu.models import cascade as jax_cascade
from deepfly3d_tpu.models.hourglass import load_weights as jax_load
from deepfly3d_tpu.ops import geometry as jax_geo
from deepfly3d_torch.models import cascade as port_cascade
from deepfly3d_torch.models.hourglass import load_weights as port_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(REPO, "weights", "hourglass_fly_fast_nearparity.npz")
TEACHER = os.path.join(REPO, "weights", "hourglass_fly.npz")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pipeline import _import_bench  # noqa: E402


def _calib():
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        return jax_geo.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)


@pytest.fixture(scope="module")
def golden_p38():
    with open(os.path.join(REPO, "tests", "data", "reference_df3d", "df3d_result_2d.pkl"),
              "rb") as f:
        golden = pickle.load(f)
    return np.asarray(golden["points2d"], np.float32), np.asarray(golden["camera_ordering"])


def test_loo_suspicion_matches_jax_and_blames_planted_camera(golden_p38):
    p38, order = golden_p38
    p38 = p38.copy()
    cam, t, joint = int(order[0]), 4, 7
    p38[cam, t, joint, 0] += np.float32(0.3)           # one wrong cell, 144 px off
    R, tvec, intr, _ = _calib()
    want = np.asarray(jax_cascade.loo_suspicion(
        jnp.asarray(p38), jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr), (960, 480)))
    got = port_cascade.loo_suspicion(
        torch.from_numpy(p38), torch.from_numpy(R), torch.from_numpy(tvec),
        torch.from_numpy(intr), (960, 480)).numpy()
    assert got.shape == want.shape == (7, 15)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
    for scores in (got, want):
        assert np.unravel_index(np.argmax(scores), scores.shape) == (cam, t)
        np.testing.assert_array_equal(scores[int(order[3])], 0.0)   # middle camera


def test_top_r_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, size=40).astype(np.float32)
    scores[::7] = 0.0
    for r in (1, 5, 13, 40):
        _, want = jax.lax.top_k(jnp.asarray(scores), r)
        got = port_cascade.top_r(torch.from_numpy(scores), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def runs():
    bench = _import_bench()
    frames, golden = bench.load_golden_frames()
    order = golden["camera_ordering"]
    calib = _calib()
    svars, sspec = jax_load(STUDENT)
    tvars, tspec = jax_load(TEACHER)
    rig = bench._load_rig()
    jpipe = jax_cascade.build_cascade_pipeline(svars, sspec, tvars, tspec, calib, order,
                                               jax_cascade.CascadeConfig(), rig=rig)
    jout = [np.asarray(a) for a in jpipe(frames)]
    # JAX's repaired images: the top R of its loo_suspicion on its student's points
    jstudent = bench.build_pipeline(sspec, svars, calib, order, tuple(sspec.input_shape),
                                    rig="auto")
    _, jp38_s, _ = jstudent(frames)
    R, tvec, intr, _ = calib
    score = jax_cascade.loo_suspicion(jp38_s, jnp.asarray(R), jnp.asarray(tvec),
                                      jnp.asarray(intr), (960, 480))
    n = frames.shape[0] * 7
    _, jidx = jax.lax.top_k(score.T.reshape(n), int(np.ceil(0.125 * n)))

    ppipe = port_cascade.build_cascade_pipeline(
        *port_load(STUDENT), *port_load(TEACHER), calib, order, rig="auto", device="cpu")
    pout = [t.numpy() for t in ppipe(frames)]
    return {"jax": jout, "port": pout, "jax_repaired": np.asarray(jidx),
            "port_repaired": ppipe.last_repaired.numpy(), "golden": golden, "frames": frames}


def test_cascade_repairs_the_same_images(runs):
    assert runs["port_repaired"].shape == (14,)
    np.testing.assert_array_equal(runs["port_repaired"], runs["jax_repaired"])


def test_cascade_same_argmax_cells(runs):
    """The student's 48x96 grid is no power of two, and XLA's jit turns the
    decode's division by 96 into a product with float32(1/96), one ulp off
    the IEEE division the port (and eager JAX) computes.  A difference below
    1e-6 is the same cell: cells are at least 1/128 apart."""
    got, want = runs["port"][1], runs["jax"][1]
    assert got.shape == (7, 15, 38, 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(got == 1, want == 1)


def test_cascade_confidence_within_2e5(runs):
    assert runs["port"][2].shape == (7, 15, 19, 1)
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], atol=2e-5, rtol=0)


def test_cascade_points3d_within_rtol(runs):
    p3d, j3d = runs["port"][0], runs["jax"][0]
    assert p3d.shape == (15, 38, 3) and np.isfinite(p3d).all()
    np.testing.assert_allclose(p3d, j3d, rtol=1e-4, atol=1e-4 * np.abs(j3d).max())
    golden = runs["golden"]
    print(f"cascade golden contract (information): pts_err "
          f"{np.abs(runs['port'][1] - golden['points2d']).max()}, conf_err "
          f"{np.abs(runs['port'][2] - golden['heatmap_confidence']).max()}")


def test_plain_twin_swaps_both_nets():
    from deepfly3d_torch.ops.bottleneck import bottleneck_plain, fused_bottleneck
    from deepfly3d_torch.ops.kernels import upsample2x_add, upsample2x_add_plain
    from deepfly3d_torch.pipeline import plain_twin

    pipe = port_cascade.build_cascade_pipeline(*port_load(STUDENT), *port_load(TEACHER),
                                               _calib(), list(range(7)), rig=None,
                                               device="cpu")
    twin = plain_twin(pipe)
    assert list(twin.nets()) == ["net", "teacher"]
    for attr, net in twin.nets().items():
        assert net is not pipe.nets()[attr]
        assert (net.block_fn, net.merge_fn) == (bottleneck_plain, upsample2x_add_plain)
        assert (pipe.nets()[attr].block_fn, pipe.nets()[attr].merge_fn) == (
            fused_bottleneck, upsample2x_add)


def test_build_cascade_pipeline_requires_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_cascade.build_cascade_pipeline(*port_load(STUDENT), *port_load(TEACHER),
                                            _calib(), list(range(7)))
