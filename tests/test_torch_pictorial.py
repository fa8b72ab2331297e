"""The port's pictorial-structures MAP (``ops/pictorial.py``) vs the JAX package's.

* ``top_k_peaks`` with planted ties: the lower index first, as
  ``jax.lax.top_k``; ``_chain_viterbi`` on the exact case of
  ``tests/test_pictorial.py`` and on random batched chains.
* ``correct_legs_map`` against JAX on the same candidates, at 1e-3.
* The corruption-recovery golden (``tests/data/pictorial_golden.pkl``)
  through a jax-free copy of ``tests/_pictorial_harness.py``'s
  ``build_side_problem`` on the port's geometry: the JAX test's recovery
  rates and the artifact's atol 1e-3.
* ``Core.solve_pictorial`` on the bundled recording's first 2 frames (golden
  2D, golden calibration, the conv checkpoint's heatmaps on the CPU) against
  the JAX ``Core``'s: the corrected 2D leg points within 1e-3 normalized.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _pictorial_harness as H
from deepfly3d_tpu.core import Core as JaxCore
from deepfly3d_tpu.ops import pictorial as jax_pic
from deepfly3d_torch.config import fly_config
from deepfly3d_torch.core import Core
from deepfly3d_torch.io import result_schema
from deepfly3d_torch.ops import geometry as port_geo
from deepfly3d_torch.ops import pictorial as port_pic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "tests", "data", "pictorial_golden.pkl")
ATOL = 1e-3


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def test_top_k_peaks_ties_take_the_lower_index():
    hm = np.zeros((2, 8, 16, 3), np.float32)
    hm[0, 3, 10, 1] = 2.0
    hm[0, 5, 2, 1] = hm[0, 1, 7, 1] = hm[0, 6, 0, 1] = 1.5   # tied: row-major order
    hm[1, :, :, 2] = np.random.default_rng(0).integers(0, 3, (8, 16))  # many ties
    coords, scores = port_pic.top_k_peaks(torch.from_numpy(hm), k=6)
    want_c, want_s = jax_pic.top_k_peaks(jnp.asarray(hm), k=6)
    assert coords.shape == (2, 3, 6, 2) and scores.shape == (2, 3, 6)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(coords[0, 1, :4].numpy(),
                                  [[3 / 8, 10 / 16], [1 / 8, 7 / 16], [5 / 8, 2 / 16],
                                   [6 / 8, 0.0]])
    np.testing.assert_array_equal(coords[0, 0].numpy(),        # an all-zero map: cells 0..5
                                  [[0.0, i / 16] for i in range(6)])


def test_chain_viterbi_exact():
    unary = torch.tensor([[0.0, 1.0], [5.0, 0.0], [0.0, 2.0]])
    pairwise = torch.tensor([[[0.0, 0.0], [-100.0, 0.0]], [[0.0, 0.0], [0.0, 0.0]]])
    idx, score = port_pic._chain_viterbi(unary, pairwise)
    assert idx.tolist() == [0, 0, 1]
    assert float(score) == pytest.approx(7.0)


def test_chain_viterbi_batched_matches_jax():
    rng = np.random.default_rng(1)
    unary = rng.integers(-3, 4, (6, 5, 7)).astype(np.float32)     # integer scores: ties
    pairwise = rng.integers(-3, 4, (6, 4, 7, 7)).astype(np.float32)
    idx, score = port_pic._chain_viterbi(torch.from_numpy(unary), torch.from_numpy(pairwise))
    for b in range(6):
        want_idx, want_score = jax_pic._chain_viterbi(jnp.asarray(unary[b]),
                                                      jnp.asarray(pairwise[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(want_idx))
        assert float(score[b]) == float(want_score)


def test_triangulate_pair_matches_jax():
    """Two views of points in front of the rig, with pixel noise."""
    _, cand, _, Ps, _ = _outlier_chain()
    xy = cand[:2, 0].reshape(2, -1, 2).astype(np.float32)        # (2 cams, 20, 2)
    P = Ps.astype(np.float32)
    got = port_pic._triangulate_pair(_t(xy[0]), _t(xy[1]), _t(P[0]), _t(P[1])).numpy()
    for i in range(xy.shape[1]):
        want = np.asarray(jax_pic._triangulate_pair(jnp.asarray(xy[0, i]), jnp.asarray(xy[1, i]),
                                                    jnp.asarray(P[0]), jnp.asarray(P[1])))
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def _outlier_chain():
    """tests/test_pictorial.py's rig: a 5-joint chain, camera 0's top
    candidate of joint 2 replaced by a gross outlier."""
    K = np.array([[900.0, 0, 320], [0, 900.0, 240], [0, 0, 1]])
    Ps = []
    for c in range(3):
        R = port_geo.rodrigues(torch.tensor([0.0, 0.5 * (c - 1), 0.0],
                                            dtype=torch.float64)).numpy()
        Ps.append(K @ np.hstack([R, np.array([[0.0], [0.0], [10.0]])]))
    Ps = np.array(Ps)
    rng = np.random.default_rng(1)
    chain = np.cumsum(np.concatenate([np.zeros((1, 3)), rng.normal(size=(4, 3)) * 0.1 + 0.3]),
                      axis=0)
    cand = np.zeros((3, 5, 4, 2))
    scores = np.zeros((3, 5, 4))
    for c in range(3):
        h = Ps[c, :, :3] @ chain.T + Ps[c, :, 3:]
        true_px = (h[:2] / h[2]).T
        for j in range(5):
            cand[c, j, 0], scores[c, j, 0] = true_px[j], 1.0
            for k in range(1, 4):
                cand[c, j, k], scores[c, j, k] = true_px[j] + rng.normal(size=2) * 40, 0.3
    cand[0, 2, 1], scores[0, 2, 1] = cand[0, 2, 0], 0.9
    cand[0, 2, 0] = cand[0, 2, 0] + np.array([150.0, -120.0])
    seg = np.linalg.norm(np.diff(chain, axis=0), axis=-1)
    return chain, cand[:, None], scores[:, None], Ps, seg


def test_outlier_candidate_corrected_matches_jax():
    chain, cand, scores, Ps, seg = _outlier_chain()
    params = port_pic.PictorialParams(num_peak=4, upper_bound=64)
    got = port_pic.correct_legs_map(_t(cand), _t(scores), _t(Ps), _t(seg), _t(seg * 0 + 0.05),
                                    params, legs=1, leg_len=5).numpy()[0]
    want = np.asarray(jax_pic.correct_legs_map(
        jnp.asarray(cand, jnp.float32), jnp.asarray(scores, jnp.float32),
        jnp.asarray(Ps, jnp.float32), jnp.asarray(seg, jnp.float32),
        jnp.asarray(seg * 0 + 0.05, jnp.float32),
        jax_pic.PictorialParams(num_peak=4, upper_bound=64), legs=1, leg_len=5))[0]
    assert np.linalg.norm(got - chain, axis=-1).max() < 0.05
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # one chain without the (frame, leg) batch: the same points
    pts, score = port_pic.solve_leg_map(_t(cand[:, 0]), _t(scores[:, 0]), _t(Ps), _t(seg),
                                        _t(seg * 0 + 0.05), params)
    np.testing.assert_array_equal(pts.numpy(), got)
    assert score.shape == ()


def _side_problem(golden_2d, golden_3d, positions, joint0):
    """A jax-free copy of _pictorial_harness.build_side_problem: the same seeded
    corruption, the projection matrices from the port's geometry."""
    order = list(golden_2d["camera_ordering"])
    cams = [order[p] for p in positions]
    p2 = np.asarray(golden_2d["points2d"])[cams, :, joint0:joint0 + 15]
    T = p2.shape[1]
    px = np.stack([p2[..., 1] * H.IMAGE_W, p2[..., 0] * H.IMAGE_H], axis=-1)
    vis = (p2[..., 0] != 0) & (p2[..., 1] != 0) & (p2[..., 1] != 1.0)
    vis_all = vis.all(axis=0)
    rng = np.random.default_rng(H.SEED)
    corrupt = [(c, t, j) for c in range(3) for t in range(T) for j in range(15)
               if vis_all[t, j] and rng.random() < H.CORRUPT_FRACTION]
    cand = np.zeros((3, T, 15, H.NUM_PEAK, 2))
    scores = np.zeros((3, T, 15, H.NUM_PEAK))
    cand[..., 0, :] = px
    scores[..., 0] = 1.0
    for k in range(1, H.NUM_PEAK):
        cand[..., k, :] = px + rng.uniform(-120, 120, size=px.shape)
        scores[..., k] = 0.3
    for (c, t, j) in corrupt:
        cand[c, t, j, 1] = cand[c, t, j, 0]
        scores[c, t, j, 1] = 0.85
        cand[c, t, j, 0] = [rng.uniform(0, H.IMAGE_W), rng.uniform(0, H.IMAGE_H)]
        scores[c, t, j, 0] = 1.0
    R, tvec, intr, _ = port_geo.calib_to_arrays({i: golden_3d[c] for i, c in enumerate(cams)},
                                                3)
    P = port_geo.projection_matrices(*(torch.from_numpy(a) for a in (R, tvec, intr))).numpy()
    return {"cand": cand, "scores": scores, "P": P, "px": px, "vis": vis,
            "corrupt": corrupt, "T": T}


@pytest.mark.parametrize("side,positions,joint0", H.SIDES, ids=["left", "right"])
def test_golden_corruption_recovery(side, positions, joint0, golden_2d, golden_3d):
    with open(ARTIFACT, "rb") as f:
        artifact = pickle.load(f)
    problem = _side_problem(golden_2d, golden_3d, positions, joint0)
    ref = H.build_side_problem(golden_2d, golden_3d, positions, joint0)
    assert problem["corrupt"] == ref["corrupt"] == artifact[side]["corrupt"]
    np.testing.assert_array_equal(problem["cand"], ref["cand"])
    np.testing.assert_allclose(problem["P"], ref["P"], rtol=1e-14)
    edge = np.asarray([joint0 + l * 5 + e + 1 for l in range(3) for e in range(4)])
    bp = fly_config().skeleton.bone_param
    pts3d = port_pic.correct_legs_map(_t(problem["cand"]), _t(problem["scores"]),
                                      _t(problem["P"]), _t(bp[edge, 0]),
                                      _t(bp[edge, 1])).numpy()
    assert pts3d.shape == (problem["T"], 15, 3)

    err = np.linalg.norm(H.reproject(problem["P"], pts3d) - problem["px"], axis=-1)
    corrupt = problem["corrupt"]
    assert len(corrupt) > 80
    cerr = np.array([err[c, t, j] for (c, t, j) in corrupt])
    assert (cerr < 10.0).mean() >= 0.90, (cerr < 10.0).mean()
    assert np.median(cerr) < 3.0
    clean = problem["vis"].copy()
    for (c, t, j) in corrupt:
        clean[c, t, j] = False
    assert np.median(err[clean]) < 3.0
    np.testing.assert_allclose(pts3d, artifact[side]["points3d"], atol=ATOL)


def test_solve_pictorial_matches_jax_core(working_images, golden_2d, golden_3d):
    """2 frames, golden 2D and golden calibration: the JAX test's criteria
    (tests/test_core.py::TestPictorial) and the JAX Core's corrected points."""
    results = []
    for cls, kw in ((JaxCore, {}), (Core, {"device": "cpu"})):
        core = cls(input_folder=working_images, output_folder=working_images + f"_{len(results)}",
                   num_images_max=2, camera_ordering=list(range(7)), **kw)
        core.points2d = np.array(golden_2d["points2d"][:, :2])
        core.conf = np.array(golden_2d["heatmap_confidence"][:, :2])
        core.calib = result_schema.extract_calib(golden_3d)
        before = np.array(core.points2d)
        out = core.solve_pictorial(apply=True)
        results.append((out, np.array(core.points2d), before))
    (want_out, want_p2, _), (out, got_p2, before) = results
    for side in ("left", "right"):
        assert out[side].shape == (2, 15, 3) and np.isfinite(out[side]).all()
        np.testing.assert_allclose(out[side], want_out[side], atol=ATOL, rtol=0)
    assert not np.allclose(got_p2, before)
    assert np.median(np.abs(got_p2[0, :, :15] - before[0, :, :15])) < 0.01
    np.testing.assert_allclose(got_p2, want_p2, atol=ATOL, rtol=0)
