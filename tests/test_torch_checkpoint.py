"""Port's checkpoint reader and weight fold vs the JAX package's.

Every hourglass checkpoint in weights/ loads to the same spec fields and the
same arrays in both packages; ``fold_hourglass`` gives the same folded
arrays (atol 0: both fold in float64 and cast once to float32).  The JAX
``fold_hourglass`` knows only the conv stem with a 1x1 score head; for the
other checkpoints the port's fold is held to the JAX fold helpers
(``_fold_conv_bn``, ``fold_bottleneck``) piece by piece, and its block
names to the checkpoint's own Bottleneck modules.  Also pins that the port
imports neither jax nor deepfly3d_tpu.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from deepfly3d_tpu.models import fused_inference as jax_fused
from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_torch.models import fused_inference as port_fused
from deepfly3d_torch.models import hourglass as port_hg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(REPO, "weights", "hourglass_*.npz")))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                out.update(_flat(item, f"{key}/{i}"))
        else:
            out[key] = np.asarray(v)
    return out


def test_checkpoints_found():
    assert "hourglass_fly.npz" in CHECKPOINTS and len(CHECKPOINTS) >= 2


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_load_weights_matches_jax(name):
    path = os.path.join(REPO, "weights", name)
    jvars, jspec = jax_hg.load_weights(path)
    pvars, pspec = port_hg.load_weights(path)
    jfields = dataclasses.asdict(jspec)
    pfields = dataclasses.asdict(pspec)
    jfields.pop("compute_dtype")
    assert pfields.pop("compute_dtype") == "float32"
    assert pfields == jfields
    jflat, pflat = _flat(jvars), _flat(pvars)
    assert sorted(jflat) == sorted(pflat)
    for k in jflat:
        assert pflat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(pflat[k], jflat[k], err_msg=k)


def _jax_fold_pieces(jvars, jspec):
    """The folded arrays of any shipped spec, from the JAX fold helpers."""
    params, stats = jvars["params"], jvars["batch_stats"]
    stem = "stem_conv" if jspec.stem == "conv" else "patch_embed"
    out = {}
    out["stem_w"], out["stem_b"] = jax_fused._fold_conv_bn(
        params[stem], params["stem_bn"], stats["stem_bn"], np.float32)

    def bottlenecks(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and "conv1" in v:
                yield name
            elif isinstance(v, dict):
                yield from bottlenecks(v, name)

    for name in bottlenecks(params):
        p, st = params, stats
        for part in name.split("/"):
            p, st = p[part], st[part]
        for k, v in jax_fused.fold_bottleneck(p, st, dtype=np.float32).items():
            out[f"blocks/{name}/{k}"] = v
    for s in range(jspec.num_stacks):
        fw, out[f"stacks/{s}/feat_b"] = jax_fused._fold_conv_bn(
            params[f"feat_conv{s}"], params[f"feat_bn{s}"], stats[f"feat_bn{s}"], np.float32)
        out[f"stacks/{s}/feat_w"] = fw[0, 0]
        score = np.asarray(params[f"score{s}"]["kernel"])
        out[f"stacks/{s}/score_w"] = score[0, 0] if jspec.score_ksize == 1 else score
        out[f"stacks/{s}/score_b"] = params[f"score{s}"]["bias"]
        if s < jspec.num_stacks - 1:
            for kind in ("feat", "score"):
                out[f"stacks/{s}/remap_{kind}_w"] = np.asarray(
                    params[f"remap_{kind}{s}"]["kernel"])[0, 0]
                out[f"stacks/{s}/remap_{kind}_b"] = params[f"remap_{kind}{s}"]["bias"]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_fold_hourglass_matches_jax_or_raises(name):
    path = os.path.join(REPO, "weights", name)
    pvars, pspec = port_hg.load_weights(path)
    jvars, jspec = jax_hg.load_weights(path)
    pfold = _flat(_to_numpy(port_fused.fold_hourglass(pvars, pspec)))
    if jspec.stem == "conv" and jspec.score_ksize == 1:      # the JAX fold covers it
        jfold = _flat(jax_fused.fold_hourglass(jvars, jspec))
    else:
        jfold = _jax_fold_pieces(jvars, jspec)
        assert sorted(f"blocks/{b}/w1" for b in port_fused.block_names(pspec)) == sorted(
            k for k in jfold if k.startswith("blocks/") and k.endswith("/w1"))
    assert sorted(pfold) == sorted(jfold)
    for k in jfold:
        assert pfold[k].dtype == np.float32, k
        np.testing.assert_array_equal(pfold[k], jfold[k], err_msg=k)
    # the raw-input projection folds the same arrays and flags the projecting blocks
    raw = port_fused.fold_hourglass(pvars, dataclasses.replace(pspec, proj_from_raw=True))
    projecting = sorted(b for b, t in raw["blocks"].items() if "wp" in t)
    assert sorted(b for b, t in raw["blocks"].items() if "proj_raw" in t) == projecting
    rfold = _flat(_to_numpy(raw))
    assert sorted(rfold) == sorted(list(pfold) + [f"blocks/{b}/proj_raw" for b in projecting])
    for k in pfold:
        np.testing.assert_array_equal(rfold[k], pfold[k], err_msg=k)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def test_fold_tiny_two_stack_spec_matches_jax():
    spec = jax_hg.HourglassSpec(num_stacks=2, features=16, depth=2, num_classes=5)
    jvars = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(spec, (32, 64), jax.random.PRNGKey(3)))
    pspec = port_hg.HourglassSpec(num_stacks=2, features=16, depth=2, num_classes=5)
    jfolded = jax_fused.fold_hourglass(jvars, spec)
    jfold = _flat(jfolded)
    pfold = _flat(_to_numpy(port_fused.fold_hourglass(jvars, pspec)))
    assert sorted(pfold) == sorted(jfold)
    for k in jfold:
        np.testing.assert_array_equal(pfold[k], jfold[k], err_msg=k)
    assert sorted(port_fused.block_names(pspec)) == sorted(jfolded["blocks"])


def test_load_weights_rejects_unknown_spec_field(tmp_path):
    path = str(tmp_path / "odd.npz")
    np.savez(path, **{"__spec__/features": np.asarray(8),
                      "__spec__/not_a_field": np.asarray(1)})
    with pytest.raises(ValueError):
        port_hg.load_weights(path)


def test_port_imports_no_jax():
    code = ("import sys, deepfly3d_torch, deepfly3d_torch.pipeline, "
            "deepfly3d_torch.models.inference, deepfly3d_torch.models.cascade; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m.startswith('deepfly3d_tpu') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
