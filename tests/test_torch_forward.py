"""Port's folded hourglass forward vs the JAX package's, on the CPU.

A small spec (16 features, depth 2, 2 stacks so the re-injection between
stacks is covered) with JAX-initialised weights and batch statistics moved
away from their init, so every fold is exercised.  Each stack's heatmaps
are compared with the JAX folded forward ``fused_apply`` (atol 1e-5) and
with the flax graph ``HourglassNet.apply(train=False)`` (atol 1e-4, the
precedent of tests/test_convert_torch_forward.py).  Plus the decoded
points of the last stack.

Every stem (conv, patchify, patch8, patch16) with both heads (1x1 score,
and a 3x3 score conv into a 2x subpixel head, with ``hp_scope="score"``)
is held to ``HourglassNet.apply`` the same way; the JAX ``fused_apply``
covers only the conv stem with a 1x1 head.  ``proj_from_raw`` (the skip
projection reads the raw block input) is held to ``HourglassNet.apply``
too; the JAX fold ignores it.  Specs the port does not compute (an even
score kernel, a float16 compute dtype, an unknown stem, a head upsampling
below 1) raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfly3d_tpu.models import decode as jax_decode
from deepfly3d_tpu.models import fused_inference as jax_fused
from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_torch.models import decode as port_decode
from deepfly3d_torch.models import fused_inference as port_fused
from deepfly3d_torch.models import hourglass as port_hg

SPEC_KW = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=19)
INPUT = (64, 128)


@pytest.fixture(scope="module")
def outputs():
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(spec, INPUT, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.2 * rng.normal(size=a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    variables = {"params": params, "batch_stats": stats}
    x = rng.uniform(size=(3,) + INPUT + (3,)).astype(np.float32)

    flax = np.asarray(jax_hg.HourglassNet(spec).apply(variables, jnp.asarray(x), train=False))
    fused = np.asarray(jax_fused.fused_apply(
        jax_fused.fold_hourglass(variables, spec), spec, jnp.asarray(x)))
    pspec = port_hg.HourglassSpec(**SPEC_KW)
    net = port_fused.FoldedHourglass(port_fused.fold_hourglass(variables, pspec), pspec)
    with torch.no_grad():
        port = net(torch.from_numpy(x)).numpy()
    return {"flax": flax, "fused_apply": fused, "port": port}


@pytest.mark.parametrize("reference,atol", [("fused_apply", 1e-5), ("flax", 1e-4)])
@pytest.mark.parametrize("stack", [0, 1])
def test_stack_heatmaps(outputs, reference, atol, stack):
    want = outputs[reference][stack]
    got = outputs["port"][stack]
    assert got.shape == want.shape == (3, 16, 32, 19)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_decoded_last_stack(outputs):
    pts_j, conf_j = jax_decode.decode_argmax(jnp.asarray(outputs["fused_apply"][-1]))
    pts_p, conf_p = port_decode.decode_argmax(torch.from_numpy(outputs["port"][-1]))
    np.testing.assert_array_equal(pts_p.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(conf_p.numpy(), np.asarray(conf_j), atol=1e-5)


def test_block_count_of_shipped_spec():
    spec = port_hg.HourglassSpec(num_stacks=2, features=96, depth=4)
    assert len(port_fused.block_names(spec)) == 31


def _moved_variables(spec, input_shape, seed):
    """JAX-initialised variables with weights and batch statistics moved off init."""
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(spec, input_shape, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.2 * rng.normal(size=a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    return {"params": params, "batch_stats": stats}, rng


HEADS = {"1x1": dict(), "3x3_subpixel": dict(score_ksize=3, head_upsample=2, hp_scope="score")}


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("stem", ["conv", "patchify", "patch8", "patch16"])
def test_stem_and_head_match_flax(stem, head):
    kw = dict(SPEC_KW, stem=stem, **HEADS[head])
    spec = jax_hg.HourglassSpec(**kw)
    variables, rng = _moved_variables(spec, INPUT, seed=len(stem) + len(head))
    x = rng.uniform(size=(2,) + INPUT + (3,)).astype(np.float32)
    want = np.asarray(jax_hg.HourglassNet(spec).apply(variables, jnp.asarray(x), train=False))
    pspec = port_hg.HourglassSpec(**kw)
    net = port_fused.FoldedHourglass(port_fused.fold_hourglass(variables, pspec), pspec)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[:2] == (2, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    pts_j, conf_j = jax_decode.decode_argmax(jnp.asarray(want[-1]))
    pts_p, conf_p = port_decode.decode_argmax(torch.from_numpy(got[-1]))
    np.testing.assert_array_equal(pts_p.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(conf_p.numpy(), np.asarray(conf_j), atol=1e-4)


@pytest.mark.parametrize("field", [dict(head_upsample=0), dict(score_ksize=2),
                                   dict(compute_dtype="float16"), dict(stem="patch4")])
def test_uncovered_spec_raises(field):
    spec = dataclasses.replace(port_hg.HourglassSpec(**SPEC_KW), **field)
    with pytest.raises(ValueError):
        port_fused.check_foldable(spec)


def test_proj_from_raw_matches_flax():
    """The raw-input projection (checkpoints converted from torch) folds:
    the projecting blocks carry the flag, and the forward is flax's."""
    kw = dict(SPEC_KW, proj_from_raw=True)
    spec = jax_hg.HourglassSpec(**kw)
    variables, rng = _moved_variables(spec, INPUT, seed=11)
    x = rng.uniform(size=(2,) + INPUT + (3,)).astype(np.float32)
    want = np.asarray(jax_hg.HourglassNet(spec).apply(variables, jnp.asarray(x), train=False))
    pspec = port_hg.HourglassSpec(**kw)
    folded = port_fused.fold_hourglass(variables, pspec)
    assert [n for n, b in folded["blocks"].items() if "proj_raw" in b] == ["stem_res1"]
    with torch.no_grad():
        got = port_fused.FoldedHourglass(folded, pspec)(torch.from_numpy(x)).numpy()
        native = port_fused.FoldedHourglass(port_fused.fold_hourglass(
            variables, dataclasses.replace(pspec, proj_from_raw=False)), pspec)(
                torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(native - want).max() > 1e-3       # the flag changes the function


def test_block_count_of_patch_stem_spec():
    spec = port_hg.HourglassSpec(num_stacks=1, features=96, depth=4, stem="patch16")
    names = port_fused.block_names(spec)
    assert len(names) == 16 and "stem_res1" not in names
