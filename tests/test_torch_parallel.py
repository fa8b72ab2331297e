"""The port's ``parallel/`` (mesh, sharded inference and triangulation,
batched Levenberg-Marquardt) vs the JAX package's, on the CPU.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's analogue is a mesh over an explicit list of 8 ``cpu`` entries.

* ``make_sharded_infer``: the spec, seed and images of
  ``tests/test_sharding.py::test_sharded_infer_matches_single_device`` (1
  stack, 16 features, depth 2, 64x128 input, 2 frames x 7 cameras padded to
  16), the JAX ``init_params`` variables handed over as numpy: the same
  cells as JAX's sharded result (within 1e-6; cells are >= 1/128 apart) and
  conf within 2e-5 (the float32 forwards sum in other orders); against the
  port's own ``infer_batch``, points within 1e-6 and conf within 1e-5 (JAX's
  tolerance in that test).
* ``make_sharded_triangulate``: float64 golden 2D, atol 1e-5 against JAX's
  and against the golden pickle (``tests/test_sharding.py``'s tolerance).
* ``make_batched_calibration`` on the synthetic scene of
  ``tests/test_sharding.py::test_batched_calibration_vmapped``, three members
  with perturbations of different sizes, so that they stop at different
  iterations: each member has the iteration count of its own unbatched
  ``_lm_solve``, its cameras within 1e-10 of the largest camera parameter
  (float64 sums in another order, moved along the free-point gauge), and is
  held to JAX's batched result at the ``lm`` tolerances (calibration 1e-4,
  points 1e-5).  The same with ``huber_delta`` and planted outliers, cut to 10
  iterations (the Huber solves follow the round-off after that in both
  packages, ROADMAP.md Queue 3).
* ``deepfly3d_torch/data/parallel_lm_b8.npz`` holds JAX's batched solve of 8
  perturbed copies of the golden problem, which ``chip_smoke.py`` holds the
  card to; the port on the CPU must match it at the same tolerances.
  Regenerate it with

      python tests/test_torch_parallel.py --write
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import conftest  # noqa: F401  (keeps JAX on the CPU, 8 virtual devices)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import deepfly3d_tpu.parallel as jax_parallel  # noqa: E402
from deepfly3d_tpu.models import hourglass as jax_hg  # noqa: E402
from deepfly3d_tpu.ops import bundle_adjust as jax_ba  # noqa: E402
from deepfly3d_tpu.ops import geometry as jax_geo  # noqa: E402
from deepfly3d_tpu.parallel import mesh as jax_mesh  # noqa: E402
from deepfly3d_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
import deepfly3d_torch.parallel as port_parallel  # noqa: E402
from deepfly3d_torch.io import discovery  # noqa: E402
from deepfly3d_torch.models import hourglass as port_hg  # noqa: E402
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass  # noqa: E402
from deepfly3d_torch.models.inference import infer_batch  # noqa: E402
from deepfly3d_torch.ops import bundle_adjust as port_ba  # noqa: E402
from deepfly3d_torch.ops import geometry as port_geo  # noqa: E402
from deepfly3d_torch.parallel import mesh  # noqa: E402
from deepfly3d_torch.parallel import pipeline  # noqa: E402

REFERENCE = os.path.join(REPO, "tests", "data", "reference")
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "reference_df3d")
LM_REF = os.path.join(REPO, "deepfly3d_torch", "data", "parallel_lm_b8.npz")
CPU8 = ["cpu"] * 8
SPEC_KW = dict(num_stacks=1, features=16, depth=2, num_classes=19)
INPUT = (64, 128)
CALIB_ATOL, PTS_ATOL, SAME_SOLVE_RTOL = 1e-4, 1e-5, 1e-10
# the synthetic members' perturbations (plain solves stop after 5, 6 and 9 iterations)
SYN_SIZES = (0.02, 0.1, 0.3)
# the chip smoke run's batched solve: 8 copies of the golden problem, the
# cameras moved by seeded normals of these sizes (rotations in radians,
# translations 10x), the points by 0.01
LM_SCALES = (0.0, 0.01, 0.03, 0.1, 0.2, 0.3, 0.5, 0.7)
LM_ITERS = 20


def _t(a):
    return torch.from_numpy(np.array(a))           # a writable copy (members of broadcast views)


# ------------------------------------------------------------------ mesh


def test_mesh_helpers():
    m = mesh.data_mesh(devices=CPU8)
    assert m.size == 8 and m.shape == {"data": 8} and m.axis_names == ("data",)
    assert mesh.data_mesh(3, devices=CPU8).size == 3
    x = np.arange(16 * 3).reshape(16, 3)
    shards = mesh.shard_batch(m, x)
    assert len(shards) == 8 and all(s.shape == (2, 3) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    # a sharding descriptor in place of the mesh
    by_desc = mesh.shard_batch(mesh.batch_sharding(m, 2), x)
    assert all(torch.equal(a, b) for a, b in zip(shards, by_desc))
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_batch(m, np.zeros((14, 3)))
    tree = {"a": np.ones(3), "b": [np.zeros(2), (np.arange(2),)]}
    for reps in (mesh.replicate(m, tree), mesh.replicate(mesh.replicated_sharding(m), tree)):
        assert len(reps) == 8
        assert all(torch.equal(r["b"][1][0], torch.arange(2)) for r in reps)
    with pytest.raises(ValueError, match="replicated"):
        mesh.replicate(mesh.batch_sharding(m, 1), tree)
    g = mesh.grid_mesh((2, 4), ("data", "time"), devices=CPU8)
    assert g.shape == {"data": 2, "time": 4} and g.devices.shape == (2, 4)
    # split over 'time', replicated over 'data'
    blocks = mesh.shard_batch(g, np.arange(8), "time")
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]] * 2
    with pytest.raises(ValueError):
        mesh.grid_mesh((3, 4), ("data", "time"), devices=CPU8)
    assert port_parallel.__all__ == jax_parallel.__all__


def test_data_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.data_mesh()
    with pytest.raises(ValueError):
        mesh.data_mesh(9, devices=CPU8)


def test_sharded_train_step_raises_naming_the_training_item():
    """The train step trains float32 (tests/test_torch_train_parallel.py) and
    bfloat16 (tests/test_torch_train_bf16.py): one bf16 step on two entries
    here; a compute dtype it does not train in raises, naming the dtype."""
    spec = dataclasses.replace(port_hg.HourglassSpec(**SPEC_KW), compute_dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        pipeline.make_sharded_train_step(spec, mesh.data_mesh(devices=CPU8))
    bf16 = dataclasses.replace(port_hg.HourglassSpec(**SPEC_KW), compute_dtype="bfloat16")
    init_fn, step_fn = pipeline.make_sharded_train_step(bf16, mesh.data_mesh(devices=CPU8[:2]))
    params, stats, opt = init_fn(0, INPUT)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2,) + INPUT + (3,)).astype(np.float32)
    t = rng.uniform(size=(2, INPUT[0] // 4, INPUT[1] // 4, 19)).astype(np.float32)
    before = params["stem_conv"]["kernel"].detach().clone()
    params, stats, opt, loss = step_fn(params, stats, opt, x, t)
    assert np.isfinite(loss.item()) and params["stem_conv"]["kernel"].dtype == torch.float32
    assert not torch.equal(before, params["stem_conv"]["kernel"])


# ------------------------------------------------------------- inference


@pytest.fixture(scope="module")
def infer_case():
    """tests/test_sharding.py's inputs: 2 frames x 7 cameras padded to 16,
    JAX's seeded variables as numpy, and JAX's sharded result."""
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables = jax_hg.init_params(spec, INPUT, jax.random.PRNGKey(0))
    paths = [os.path.join(REFERENCE, f"camera_{c}_img_{i}.jpg")
             for c in range(7) for i in range(2)]
    images = np.stack([discovery.read_image(p) for p in paths])
    flip = np.asarray([c >= 4 for c in range(7) for _ in range(2)])
    images = np.concatenate([images, images[:2]])
    flip = np.concatenate([flip, flip[:2]])
    jm = jax_mesh.data_mesh(8)
    with jm:
        infer = jax_pipeline.make_sharded_infer(spec, jm, INPUT)
        pts, conf = infer(variables, jnp.asarray(images), jnp.asarray(flip))
    return (jax.tree_util.tree_map(np.asarray, variables), images, flip,
            np.asarray(pts), np.asarray(conf))


def test_sharded_infer_matches_jax(infer_case):
    variables, images, flip, want_pts, want_conf = infer_case
    infer = pipeline.make_sharded_infer(port_hg.HourglassSpec(**SPEC_KW),
                                        mesh.data_mesh(devices=CPU8), INPUT)
    pts, conf = infer(variables, images, flip)
    assert pts.shape == (16, 19, 2) and conf.shape == (16, 19, 1)
    np.testing.assert_allclose(pts.numpy(), want_pts, atol=1e-6, rtol=0)
    np.testing.assert_allclose(conf.numpy(), want_conf, atol=2e-5, rtol=0)


def test_sharded_infer_matches_single_forward(infer_case):
    variables, images, flip, _, _ = infer_case
    spec = port_hg.HourglassSpec(**SPEC_KW)
    infer = pipeline.make_sharded_infer(spec, mesh.data_mesh(devices=CPU8), INPUT)
    pts, conf = infer(variables, images, flip)
    again = infer(variables, images, flip)          # the replicas are kept
    assert torch.equal(again[0], pts) and torch.equal(again[1], conf)
    net = FoldedHourglass(fold_hourglass(variables, spec), spec).eval()
    want = infer_batch(net, _t(images), _t(flip), INPUT)
    np.testing.assert_allclose(pts.numpy(), want[0].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(conf.numpy(), want[1].numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="evenly"):
        infer(variables, images[:14], flip[:14])


# --------------------------------------------------------- triangulation


def test_sharded_triangulate_matches_jax_and_golden(golden_3d):
    R, tvec, intr, _ = jax_geo.calib_to_arrays({c: golden_3d[c] for c in range(7)}, 7)
    # pad T=15 -> 16 so the frame axis splits evenly over 8 entries
    p2 = np.concatenate([golden_3d["points2d"], golden_3d["points2d"][:, :1]], axis=1)
    jm = jax_mesh.data_mesh(8)
    with jm:
        want = np.asarray(jax_pipeline.make_sharded_triangulate(jm, (960, 480))(
            jnp.asarray(p2), jnp.asarray(R), jnp.asarray(tvec), jnp.asarray(intr)))
    tri = pipeline.make_sharded_triangulate(mesh.data_mesh(devices=CPU8), (960, 480))
    got = tri(p2, R, tvec, intr)
    assert got.dtype == torch.float64 and got.shape == (16, 38, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[:15], golden_3d["points3d_wo_procrustes"], atol=1e-5)
    # the port's one-device triangulation of the same frames, the same default method
    one = port_geo.triangulate(_t(p2), _t(R), _t(tvec), _t(intr), (960, 480))
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-9, rtol=0)


# --------------------------------------------------------- batched LM


def _synthetic_scene():
    """tests/test_sharding.py::test_batched_calibration_vmapped's scene."""
    rng = np.random.default_rng(0)
    C, N = 3, 30
    pts = rng.normal(size=(N, 3)) * 0.3
    K = np.tile(np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]]), (C, 1, 1))
    dist = np.zeros((C, 5))
    cams_true, obs = [], np.zeros((C, N, 2))
    for c in range(C):
        rvec = np.array([0.05, 0.4 * c, 0.0])
        tvec = np.array([0.0, 0.0, 9.0])
        cams_true.append(np.concatenate([rvec, tvec]))
        R = np.asarray(jax_geo.rodrigues(jnp.asarray(rvec)))
        obs[c] = np.asarray(jax_geo.project(jnp.asarray(pts), jnp.asarray(R),
                                            jnp.asarray(tvec), jnp.asarray(K[c]),
                                            jnp.asarray(dist[c])))
    return np.stack(cams_true), pts, K, dist, obs


def _members(sizes, outliers=0):
    """B members of the synthetic scene: cameras and points moved by seeded
    normals of the given sizes, 0.5 px of noise on the observations (so that
    a solve converges to a non-zero cost and stops early), ``outliers``
    observations per member moved by 40 px."""
    cams, pts, K, dist, obs = _synthetic_scene()
    rng = np.random.default_rng(1)
    C, N = obs.shape[:2]
    out = {k: [] for k in ("cams0", "pts0", "K", "dist", "obs", "mask")}
    for size in sizes:
        o = obs + 0.5 * rng.normal(size=obs.shape)
        for _ in range(outliers):
            o[rng.integers(C), rng.integers(N)] += rng.normal(size=2) * 40
        out["cams0"].append(cams + size * rng.normal(size=cams.shape))
        out["pts0"].append(pts + size * rng.normal(size=pts.shape))
        out["K"].append(K)
        out["dist"].append(dist)
        out["obs"].append(o)
        out["mask"].append(np.ones((C, N)))
    return [np.stack(out[k]) for k in ("cams0", "pts0", "K", "dist", "obs", "mask")]


def _jax_batched(args, max_iters, huber_delta=0.0):
    if not huber_delta:
        fn = jax_pipeline.make_batched_calibration((640, 480), max_iters=max_iters)
    else:
        fn = jax.jit(jax.vmap(lambda *a: jax_ba._lm_solve(*a, max_iters=max_iters,
                                                          huber_delta=huber_delta)))
    return [np.asarray(a) for a in fn(*(jnp.asarray(a) for a in args))]


def _hold_members(got, args, want, max_iters, huber_delta=0.0):
    """Each member against its own unbatched solve (same iterations, cameras
    within SAME_SOLVE_RTOL of the largest parameter) and against JAX's
    batched result at the lm tolerances."""
    cams, pts, cost0, cost, iters = (t.numpy() for t in got)
    for b in range(len(iters)):
        one = port_ba._lm_solve(*(_t(a[b]) for a in args), max_iters=max_iters,
                                huber_delta=huber_delta)
        assert int(iters[b]) == one[4], (b, iters, one[4])
        scale = np.abs(one[0].numpy()).max()
        np.testing.assert_allclose(cams[b], one[0].numpy(), atol=SAME_SOLVE_RTOL * scale, rtol=0)
        np.testing.assert_allclose([cost0[b], cost[b]], [one[2], one[3]], rtol=1e-9)
    np.testing.assert_array_equal(iters, want[4])
    np.testing.assert_allclose(cams, want[0], atol=CALIB_ATOL, rtol=0)
    np.testing.assert_allclose(pts, want[1], atol=PTS_ATOL, rtol=0)
    np.testing.assert_allclose(cost, want[3], rtol=1e-6, atol=1e-12)


def test_batched_calibration_members_stop_apart():
    args = _members(SYN_SIZES)
    want = _jax_batched(args, 25)
    got = pipeline.make_batched_calibration((640, 480), max_iters=25, device="cpu")(*args)
    assert got[0].shape == (3, 3, 6) and got[4].dtype == torch.int64
    assert len(set(got[4].tolist())) == 3, got[4]        # three different stops
    assert bool((got[3] < got[2]).all())
    _hold_members(got, args, want, 25)


def test_batched_calibration_defaults_to_the_card():
    """The batched solve runs on the card unless the CPU is asked for, numpy
    inputs included, and raises without a card (no fallback to the host)."""
    args = _members(SYN_SIZES[:1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.make_batched_calibration((640, 480), max_iters=2)
    got = pipeline.make_batched_calibration((640, 480), max_iters=2, device="cpu")(*args)
    assert all(t.device.type == "cpu" for t in got)


def test_batched_calibration_huber():
    args = _members(SYN_SIZES, outliers=3)
    want = _jax_batched(args, 10, huber_delta=2.0)
    with torch.no_grad():
        got = port_ba._lm_solve_batched(*(_t(a) for a in args), max_iters=10, huber_delta=2.0)
    assert len(set(got[4].tolist())) > 1, got[4]          # one stops while others go on
    _hold_members(got, args, want, 10, huber_delta=2.0)


# ------------------------------------- the chip smoke run's reference (B=8)


def golden_lm_batch():
    """8 perturbed copies of the golden problem (LM_SCALES), built by the JAX
    package: {cams0 (8, 7, 6), pts0 (8, N, 3), K, dist, obs, mask} with K,
    dist, obs and mask one member's (every member's the same)."""
    with open(os.path.join(GOLDEN_DIR, "df3d_result_2d.pkl"), "rb") as f:
        golden = pickle.load(f)
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        prior = pickle.load(f)
    prior = {cidx: prior[idx] for idx, cidx in enumerate(golden["camera_ordering"])}
    C, R0, t0, K, dist, pts0, obs, mask = jax_ba._prepare(golden["points2d"], prior, (960, 480))
    cams0 = np.stack([jax_ba._pack_cam(R0[c], t0[c], K[c], dist[c], False, False)
                      for c in range(C)])
    rng = np.random.default_rng(0)
    pts0 = pts0.reshape(-1, 3)
    move = np.array([1.0, 1.0, 1.0, 10.0, 10.0, 10.0])
    return {"cams0": np.stack([cams0 + s * move * rng.normal(size=cams0.shape)
                               for s in LM_SCALES]),
            "pts0": np.stack([pts0 + 0.01 * rng.normal(size=pts0.shape) for _ in LM_SCALES]),
            "K": K, "dist": dist, "obs": obs.reshape(C, -1, 2),
            "mask": mask.reshape(C, -1).astype(np.float64)}


def _tiled(ref):
    B = ref["cams0"].shape[0]
    return [ref["cams0"], ref["pts0"]] + [np.broadcast_to(ref[k], (B,) + ref[k].shape)
                                          for k in ("K", "dist", "obs", "mask")]


def test_committed_batched_reference_matches_the_port():
    with np.load(LM_REF) as z:
        ref = {k: z[k] for k in z.files}
    assert tuple(ref["scales"]) == LM_SCALES and int(ref["max_iters"]) == LM_ITERS
    args = _tiled(ref)
    got = pipeline.make_batched_calibration((960, 480), max_iters=LM_ITERS,
                                            device="cpu")(*args)
    want = [ref[k] for k in ("cams", "pts", "cost0", "cost", "iters")]
    assert len(set(want[4].tolist())) >= 4, want[4]      # members stop apart
    _hold_members(got, args, want, LM_ITERS)


def write_reference():
    ref = golden_lm_batch()
    out = _jax_batched(_tiled(ref), LM_ITERS)
    ref.update(zip(("cams", "pts", "cost0", "cost", "iters"), out))
    ref.update(scales=np.asarray(LM_SCALES), max_iters=np.int64(LM_ITERS))
    np.savez_compressed(LM_REF, **ref)
    print(f"wrote {LM_REF}: iterations {out[4].tolist()}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_reference()
