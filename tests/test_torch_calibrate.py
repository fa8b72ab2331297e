"""The port's score-head calibration (``deepfly3d_torch/calibrate_score_head.py``)
against the JAX script (``scripts/calibrate_score_head.py``), on the CPU.

A reduced problem: a seeded 8-feature one-stack network (weights from JAX's
init, moved off it) on the 105 golden images at 256x512 (the golden cells
lie on its 64x128 decode grid), and a fit of the first ``JOINTS`` joints on the first ``NFIT`` images to
targets near the peaks of its own head scaled by ``HEAD_SCALE`` (a seeded
net is far from the golden cells, and its flat maps hold too many rivals
within the fit's 3e-3 gap floor: the fit refuses what its rival constraints
cannot hold).  Tolerances:

* ``embed_score_3x3``, ``neighborhood_rows``, ``golden_cells``,
  ``region_cells``: equal;
* ``extract_features`` at float32: features and heatmaps within 1e-5 of
  their magnitude; at bf16 against JAX's op-by-op graph (the port computes
  it, tests/test_torch_train_bf16.py) within 1e-3 of JAX's own
  bf16-vs-float32 gap;
* ``make_device_check``: within 1e-6 of the heatmaps' magnitude (float32
  convolutions in another order); ``compute_gram``: within 1e-6 of its
  largest entry;
* ``fit_scores`` on the same features and the same targets: given the same
  check and Gram, bit-equal in both packages; each with its own check and
  Gram, L_inf within 2e-5 of each other, every winner the argmax of its
  fitted map, and every peak within 1.05 ``BAND`` of its target (the band is
  a penalty: measured 1.02 ``BAND`` on peaks of ~100); the weights
  themselves differ: L-BFGS-B on the ill-conditioned penalty takes another
  path from inputs 1e-7 apart.

Plus the outer loop's files (the targets cache's path and fingerprint, its
refusals, the ``.cleanonly`` path), the "persistent violations" abort in
both packages, the holdout refusals, and a port-written calibrated
checkpoint read back by JAX to the same spec.  ~60 s single process.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import calibrate_score_head as jcal  # noqa: E402
sys.path.pop(0)

from deepfly3d_tpu.models import hourglass as jax_hg  # noqa: E402
from deepfly3d_torch import calibrate_score_head as pcal  # noqa: E402
from deepfly3d_torch.models import hourglass as port_hg  # noqa: E402

SPEC_KW = dict(num_stacks=1, features=8, depth=2, num_classes=19, stem="patchify")
INPUT = (256, 512)
JOINTS = 3
NFIT = 21               # images of the fit: fewer than the head's 9 * 8 + 1 parameters
HEAD_SCALE = 30.0       # the seeded head times this: peaks clear of the 3e-3 gap floor


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads for torch and for the BLAS under numpy and scipy
    (the fit's many small products): the suite runs 6 workers on the cores,
    and 8 threads each oversubscribe them.  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(before)


def _variables(seed=0):
    variables = jax.tree_util.tree_map(np.asarray, jax_hg.init_params(
        jax_hg.HourglassSpec(**SPEC_KW), INPUT, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
                lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
                variables["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: np.abs(a + 0.2 * rng.normal(size=a.shape)).astype(np.float32),
                variables["batch_stats"])}


def _specs(dtype):
    extra = dict(compute_dtype=dtype, hp_scope="score")
    port = port_hg.HourglassSpec(**SPEC_KW, **extra)
    jspec = jax_hg.HourglassSpec(**SPEC_KW, **dict(extra, compute_dtype=jnp.dtype(dtype).type))
    return port, jspec


@pytest.fixture(scope="module")
def embedded():
    variables = _variables()
    port_vars, port_spec = pcal.embed_score_3x3(variables, _specs("float32")[0])
    return port_vars


@pytest.fixture(scope="module")
def cached():
    """Both packages' features and heatmaps at both dtypes, the port's on the CPU."""
    variables = _variables()
    out = {}
    for dt in ("float32", "bfloat16"):
        pspec, jspec = _specs(dt)
        pv, pspec = pcal.embed_score_3x3(variables, pspec)
        jv, jspec = jcal.embed_score_3x3(variables, jspec)
        feat, heat, golden, sets = pcal.extract_features(pv, pspec, INPUT, device="cpu")
        if dt == "bfloat16":
            with jax.disable_jit():
                jfeat, jheat, _, _ = jcal.extract_features(jv, jspec, INPUT)
        else:
            jfeat, jheat, _, _ = jcal.extract_features(jv, jspec, INPUT)
        out[dt] = (feat, heat, np.asarray(jfeat), jheat, pv)
    out["golden"] = golden
    return out


def test_embed_score_3x3_matches_jax():
    variables = _variables(1)
    pv, pspec = pcal.embed_score_3x3(variables, _specs("float32")[0])
    jv, jspec = jcal.embed_score_3x3(variables, _specs("float32")[1])
    assert pspec.score_ksize == jspec.score_ksize == 3
    np.testing.assert_array_equal(pv["params"]["score0"]["kernel"],
                                  np.asarray(jv["params"]["score0"]["kernel"]))
    assert pcal.embed_score_3x3(pv, pspec)[0]["params"]["score0"] is pv["params"]["score0"]


def test_host_helpers_equal(cached):
    golden = cached["golden"]
    np.testing.assert_array_equal(pcal.golden_cells(golden, 64, 128),
                                  jcal.golden_cells(golden, 64, 128))
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(3, 8, 16, 5)).astype(np.float32)
    cells = np.array([0, 15, 17, 64, 127, 112, 50])
    for n in range(3):
        np.testing.assert_array_equal(pcal.neighborhood_rows(feat, n, cells),
                                      jcal.neighborhood_rows(feat, n, cells))
    for cell in (0, 127, 129, 4000, 64 * 128 - 1):
        np.testing.assert_array_equal(pcal.region_cells(cell, 64, 128),
                                      jcal.region_cells(cell, 64, 128))
    assert (pcal.MARGIN, pcal.EPS_FLOOR, pcal.RIDGE, pcal.BAND) == \
        (jcal.MARGIN, jcal.EPS_FLOOR, jcal.RIDGE, jcal.BAND)


def test_extract_features_matches_jax(cached):
    for dt in ("float32", "bfloat16"):
        feat, heat, jfeat, jheat, _ = cached[dt]
        assert feat.dtype == torch.float32 and feat.shape == (105, 64, 128, 8)
        assert heat.dtype == np.float64 and heat.shape == (105, 64, 128, 19)
        if dt == "float32":
            for got, want in ((feat.numpy(), jfeat), (heat, jheat)):
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-5 * float(np.abs(want).max()))
    # bf16: op by op, the same roundings
    f_bf, h_bf, jf_bf, jh_bf = cached["bfloat16"][:4]
    f32, h32 = cached["float32"][2], cached["float32"][3]
    for got, want, other in ((f_bf.numpy(), jf_bf, f32), (h_bf, jh_bf, h32)):
        gap = float(np.abs(want - other).max())
        assert float(np.abs(got - want).max()) <= 1e-3 * gap


@pytest.mark.parametrize("u", [1, 2])
def test_device_check_and_gram_match_jax(u):
    rng = np.random.default_rng(u)
    feat = rng.uniform(0, 2, size=(20, 8, 16, 6)).astype(np.float32)
    kern = rng.normal(size=(3, 3, 6, u * u))
    bias = rng.normal(size=(u * u,))
    got = pcal.make_device_check(torch.from_numpy(feat), u)(kern, bias)
    want = np.asarray(jcal.make_device_check(jnp.asarray(feat), u)(kern, bias))
    assert got.shape == want.shape == (20, 8 * u, 16 * u)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
    S = pcal.compute_gram(torch.from_numpy(feat))
    S_jax = jcal.compute_gram(jnp.asarray(feat))
    assert S.dtype == np.float64 and S.shape == (55, 55)
    np.testing.assert_allclose(S, S_jax, rtol=0, atol=1e-6 * float(np.abs(S_jax).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_scores_matches_jax_on_the_same_features(cached, dtype):
    feat, heat, _, _, variables = cached[dtype]
    feat, heat = feat[:NFIT], heat[:NFIT]
    feat_np = feat.numpy()
    # the targets are the scaled head's peaks moved by up to 4e-3, the
    # "golden" cells its argmax cells on every other image (free on the
    # rest), as for a trained net near parity
    w0 = HEAD_SCALE * np.asarray(variables["params"]["score0"]["kernel"], np.float64)[..., :JOINTS]
    b0 = HEAD_SCALE * np.asarray(variables["params"]["score0"]["bias"], np.float64)[:JOINTS]
    check = pcal.make_device_check(feat, 1)
    flat = np.stack([check(w0[..., j:j + 1], b0[j:j + 1]).reshape(NFIT, -1)
                     for j in range(JOINTS)], -1)
    rng = np.random.default_rng(0)
    targets = flat.max(1) + rng.uniform(-4e-3, 4e-3, size=(NFIT, JOINTS))
    gcells = np.where((np.arange(NFIT) % 2 == 0)[:, None], flat.argmax(1), -1)
    gram = pcal.compute_gram(feat)
    # the host fit itself: the same check and Gram in both packages -> the same bits
    got = pcal.fit_scores(check, feat_np, gram, w0, b0, targets, gcells, 1)
    same = jcal.fit_scores(check, feat_np, gram, w0, b0, targets, gcells, 1)
    for a, b in zip(got, same):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], w0)          # the fit moved the head
    # each package's own device check and Gram (float32 sums in another
    # order): L-BFGS-B on this ill-conditioned penalty takes another path,
    # so the weights differ; both fits hold the contract the fit sets out
    want = jcal.fit_scores(jcal.make_device_check(jnp.asarray(feat_np), 1), feat_np,
                           jcal.compute_gram(jnp.asarray(feat_np)), w0, b0, targets, gcells, 1)
    assert abs(got[2] - want[2]) <= 2e-5 and max(got[2], want[2]) <= 1.05 * pcal.BAND
    for w, b in (got[:2], want[:2]):
        for j in range(JOINTS):
            h = check(w[..., j:j + 1], b[j:j + 1]).reshape(NFIT, -1)
            free = gcells[:, j] < 0
            winners = np.where(free, flat[..., j].argmax(1), gcells[:, j])
            np.testing.assert_array_equal(h.argmax(1), winners)
            assert np.abs(h.max(1) - targets[:, j]).max() <= 1.05 * pcal.BAND


def test_persistent_violations_abort_in_both():
    """A rival the weights cannot move (the check ignores them) stays above
    the winner after it is pinned: both packages abort the whole fit."""
    N, H, W = 4, 4, 8
    fixed = np.zeros((N, H, W))
    fixed[:, 0, 0] = 1.0                               # the rival
    fixed[:, 2, 4] = 0.9                               # the golden cell
    check = lambda kern, bias: fixed
    feat = np.ones((N, H, W, 2), np.float32)
    S = np.eye(19)
    gcells = np.full((N, 1), 2 * W + 4)
    args = (check, feat, S, np.zeros((3, 3, 2, 1)), np.zeros(1), np.full((N, 1), 0.9), gcells, 1)
    messages = []
    for fit in (pcal.fit_scores, jcal.fit_scores):
        with pytest.raises(RuntimeError, match="persistent violations") as e:
            fit(*args)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_outer_loop_files(tmp_path):
    """The targets cache and the clean-only checkpoint as the JAX script's
    ``main`` names and reads them (its expressions, written out)."""
    assert pcal.cache_path("run") == "run.npz" and pcal.cache_path("run.npz") == "run.npz"
    assert pcal.cache_path("") == ""
    ckpt = "weights/x.npz"
    fp = pcal.cache_fingerprint(ckpt, "bfloat16", "score", "float32", [85, 75], [1.04], 0.03, 1.0)
    assert fp == repr((os.path.abspath(ckpt), "bfloat16", "score", "float32", [75, 85], [1.04],
                       0.03, 1.0))
    root, ext = os.path.splitext("out/cal.npz")
    assert pcal.cleanonly_path("out/cal.npz") == root + ".cleanonly" + (ext or ".npz")
    assert pcal.cleanonly_path("out/cal") == "out/cal.cleanonly.npz"
    t0 = np.zeros((6, 2))
    cache = str(tmp_path / "t.npz")
    assert pcal.load_targets_cache(cache, fp, t0, t0) is t0          # no file
    np.savez(cache, fit_targets=np.ones((6, 2)), fingerprint=np.str_(fp))
    np.testing.assert_array_equal(pcal.load_targets_cache(cache, fp, t0, t0), np.ones((6, 2)))
    assert pcal.load_targets_cache(cache, fp + "x", t0, t0) is t0    # another configuration
    assert pcal.load_targets_cache(cache, fp, np.zeros((5, 2)), t0).shape == (5, 2)
    np.savez(cache, fit_targets=np.ones((6, 2)))                     # no fingerprint
    assert pcal.load_targets_cache(cache, fp, t0, t0) is t0


def test_holdout_refusals_match_jax():
    for fn in ("validate_augment_qualities", "validate_augment_gains"):
        bad = [85, 90] if "qualities" in fn else [1.04, 0.95]
        for mod in (pcal, jcal):
            with pytest.raises(SystemExit):
                getattr(mod, fn)(bad)
            getattr(mod, fn)([85, 75] if "qualities" in fn else [1.04, 0.96])


def test_calibrated_checkpoint_reads_back_in_jax(tmp_path, embedded):
    spec = dataclasses.replace(port_hg.HourglassSpec(**SPEC_KW, input_shape=INPUT),
                               score_ksize=3, hp_scope="score", preprocess_dtype="bfloat16",
                               compute_dtype="bfloat16")
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port_hg.save_weights(port_path, embedded, spec)
    jvars, jspec = jax_hg.load_weights(port_path)
    assert (jspec.score_ksize, jspec.hp_scope, jspec.hp_precision, jspec.preprocess_dtype,
            jspec.input_shape, jspec.stem, jspec.features) == \
        (3, "score", "highest", "bfloat16", INPUT, "patchify", 8)
    assert jvars["params"]["score0"]["kernel"].shape == (3, 3, 8, 19)
    jax_hg.save_weights(jax_path, jvars, jspec)
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port_hg.load_weights(jax_path)[1] == dataclasses.replace(spec, compute_dtype="float32")
