"""The port's weight files, training checkpoints and torch conversion, on the CPU.

* ``save_weights``: a file the port writes is read by the JAX
  ``load_weights`` and the other way round, every array equal (atol 0) and
  the same spec fields.
* ``models/checkpoint.py``: a state tree (variables, an optimiser's
  ``state_dict``, numbers) round trips exactly, the newest three steps are
  kept, the latest is read by default.
* ``models/convert_torch.py`` against the JAX converter on synthetic state
  dicts (the canonical torch oracle of tests/torch_hg_oracle.py, randomly
  initialised, and the structural dict of tests/test_convert.py): the same
  trees, atol 0, the same refusals; the converted weights run through the
  port's folded forward (the bottleneck's raw-input projection) and its
  trainable net, held to the oracle's eval-mode forward at 1e-4 (the
  precedent of tests/test_convert_torch_forward.py); the CLI writes a file
  both packages read.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from deepfly3d_tpu.models import convert_torch as jax_convert
from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_torch.models import checkpoint as port_ckpt
from deepfly3d_torch.models import convert_torch as port_convert
from deepfly3d_torch.models import fused_inference as port_fused
from deepfly3d_torch.models import hourglass as port_hg
from deepfly3d_torch.models import train as port_train
from tests.test_convert import fake_torch_checkpoint  # noqa: F401  (fixture)
from tests.torch_hg_oracle import HourglassNet as TorchHG
from tests.torch_hg_oracle import randomize_

SPEC_KW = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=5)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ save_weights

SPEC_VARIANTS = {
    "default": {},
    "every_field": dict(stem="patch16", head_upsample=2, score_ksize=3, hp_scope="score",
                        input_shape=(32, 64), preprocess_dtype="bfloat16", bn_momentum=0.9),
    "proj_from_raw": dict(proj_from_raw=True, input_shape=(32, 64)),
}


@pytest.mark.parametrize("variant", sorted(SPEC_VARIANTS))
def test_save_weights_read_by_both_packages(tmp_path, variant):
    kw = dict(SPEC_KW, **SPEC_VARIANTS[variant])
    jspec = jax_hg.HourglassSpec(**kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(jspec, (32, 64), jax.random.PRNGKey(0)))
    pspec = port_hg.HourglassSpec(**kw)

    port_file = str(tmp_path / "port.npz")
    port_hg.save_weights(port_file, variables, pspec)
    jvars, jspec_back = jax_hg.load_weights(port_file)
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jvars), variables)
    assert dataclasses.replace(jspec_back, compute_dtype=None) == \
        dataclasses.replace(jspec, compute_dtype=None)

    jax_file = str(tmp_path / "jax.npz")
    jax_hg.save_weights(jax_file, variables, jspec)
    pvars, pspec_back = port_hg.load_weights(jax_file)
    _assert_same_tree(pvars, variables)
    assert pspec_back == pspec
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)


def test_save_weights_takes_tensors(tmp_path):
    spec = port_hg.HourglassSpec(**SPEC_KW)
    variables = port_hg.init_params(spec, (32, 64), torch.Generator().manual_seed(1),
                                    device="cpu")
    path = str(tmp_path / "init.npz")
    port_hg.save_weights(path, variables, spec)
    back, _ = port_hg.load_weights(path)
    _assert_same_tree(back, jax.tree_util.tree_map(lambda t: t.numpy(), variables))


# ------------------------------------------------------------- checkpoint


def test_checkpoint_round_trip_and_pruning(tmp_path):
    spec = port_hg.HourglassSpec(num_stacks=1, features=16, depth=2, num_classes=4,
                                 input_shape=(32, 64))
    net = port_hg.HourglassNet(spec)
    opt = port_train.adam(port_train.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10))(
        net.parameters())
    net(torch.rand(2, 32, 64, 3), train=True).square().mean().backward()
    opt.step()
    path = str(tmp_path / "ck")
    states = {}
    for step in (3, 7, 11, 12):
        states[step] = {"variables": port_hg.module_variables(net), "opt": opt.state_dict(),
                        "count": step, "note": "adam"}
        port_ckpt.save_checkpoint(path, states[step], step=step, spec=spec)
    assert port_ckpt.steps(path) == [7, 11, 12]          # max_to_keep = 3
    assert sorted(os.listdir(path)) == ["spec.json", "step_11.pt", "step_12.pt", "step_7.pt"]
    restored, spec2, step = port_ckpt.load_checkpoint(path)
    assert step == 12 and spec2 == spec
    assert restored["count"] == 12 and restored["note"] == "adam"
    a = _leaves(jax.tree_util.tree_map(lambda t: t.numpy(), restored["variables"]))
    for k, v in _leaves(states[12]["variables"]).items():
        np.testing.assert_array_equal(a[k], v, err_msg=k)
    opt2 = port_train.adam(1e-3)(net.parameters())
    opt2.load_state_dict(restored["opt"])
    assert opt2.param_groups[0]["count"] == 1
    for p in net.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt2.state[p][key], opt.state[p][key])
    older, _, step = port_ckpt.load_checkpoint(path, step=7)
    assert step == 7 and older["count"] == 7
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_checkpoint(str(tmp_path / "empty"))


# ------------------------------------------------------------- conversion


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """A random canonical torch hourglass, its state dict as a trainer
    checkpoint file, and its eval-mode heatmaps on seeded inputs."""
    model = TorchHG(2, 16, 3, 5)
    randomize_(model, seed=3)
    model.eval()
    x = np.random.default_rng(7).standard_normal((2, 3, 32, 64)).astype(np.float32)
    with torch.no_grad():
        maps = np.stack([o.numpy() for o in model(torch.from_numpy(x))])   # (S, N, K, H, W)
    path = str(tmp_path_factory.mktemp("oracle") / "oracle.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()},
                "epoch": 3}, path)
    spec_kw = dict(num_stacks=2, features=16, depth=3, num_blocks=1, num_classes=5,
                   stem="conv", proj_from_raw=True)
    return path, x, maps, spec_kw


def test_convert_checkpoint_matches_jax(oracle):
    path, _, _, spec_kw = oracle
    want = jax_convert.convert_checkpoint(path, jax_hg.HourglassSpec(**spec_kw))
    got = port_convert.convert_checkpoint(path, port_hg.HourglassSpec(**spec_kw))
    _assert_same_tree(got, want)
    sd = port_convert.load_torch_state_dict(path)
    assert not any(k.startswith("module.") or k.endswith("num_batches_tracked") for k in sd)


def test_convert_structural_dict_matches_jax(fake_torch_checkpoint):  # noqa: F811
    variables, sd = fake_torch_checkpoint
    spec_kw = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=5)
    want = jax_convert.convert_state_dict(sd, jax_hg.HourglassSpec(**spec_kw))
    got = port_convert.convert_state_dict(sd, port_hg.HourglassSpec(**spec_kw))
    for a, b in zip(got, want):
        _assert_same_tree(a, b)
    _assert_same_tree({"params": got[0], "batch_stats": got[1]},
                      jax.tree_util.tree_map(np.asarray, variables))
    extra = dict(sd, **{"stray.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="stray.weight"):
        port_convert.convert_state_dict(extra, port_hg.HourglassSpec(**spec_kw))
    params, _ = port_convert.convert_state_dict(extra, port_hg.HourglassSpec(**spec_kw),
                                                strict=False)
    assert "stray" not in params


@pytest.mark.parametrize("forward", ["folded", "trainable"])
def test_converted_forward_matches_the_torch_oracle(oracle, forward):
    path, x, maps, spec_kw = oracle
    spec = port_hg.HourglassSpec(**spec_kw)
    variables = port_convert.convert_checkpoint(path, spec)
    x_nhwc = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        if forward == "folded":
            folded = port_fused.fold_hourglass(variables, spec)
            assert "proj_raw" in folded["blocks"]["stem_res1"]
            got = port_fused.FoldedHourglass(folded, spec)(x_nhwc)
        else:
            got = port_hg.trainable(variables, spec, device="cpu")(x_nhwc)
    got = got.numpy().transpose(0, 1, 4, 2, 3)
    assert got.shape == maps.shape
    np.testing.assert_allclose(got, maps, atol=1e-4, rtol=0)


def test_convert_cli_writes_a_file_both_packages_read(oracle, tmp_path, capsys):
    path, _, _, spec_kw = oracle
    out = str(tmp_path / "converted.npz")
    assert port_convert.main([path, out, "--features", "16", "--depth", "3", "--classes", "5",
                              "--input-shape", "32", "64"]) == 0
    assert "proj_from_raw=True" in capsys.readouterr().out
    pvars, pspec = port_hg.load_weights(out)
    jvars, jspec = jax_hg.load_weights(out)
    assert pspec.proj_from_raw and jspec.proj_from_raw and pspec.input_shape == (32, 64)
    _assert_same_tree(pvars, jax.tree_util.tree_map(np.asarray, jvars))
    _assert_same_tree(pvars, jax_convert.convert_checkpoint(
        path, jax_hg.HourglassSpec(**spec_kw)))
