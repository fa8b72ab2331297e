"""The port's trainable hourglass and trainer against the JAX package's, on the CPU.

Tiny specs (16 features, depth 2, 32x64 inputs, as tests/test_model.py),
JAX-initialised weights carried over to the port (``load_variables``), and
seeded numpy inputs.  Tolerances, and why:

* forward in eval mode and the running statistics a training-mode forward
  leaves: 1e-5 of the largest magnitude (float32 sums in another order);
  the training-mode output 3e-5 of it, because its batch statistics at the
  innermost level are over as few as 24 values per channel and E[x^2] -
  E[x]^2 cancels (measured up to 1.8e-5 over the specs below);
* the gradient of the loss: 1e-4 of the largest gradient of the tree;
* K optimiser steps: losses rtol 1e-5, every parameter and statistic 1e-5
  absolute.  In training mode the biases of convolutions that a batch norm
  follows on every path (all but the score heads') have a gradient that is
  rounding noise in both packages (pinned below at 1e-5 of the largest
  gradient); Adam at its default epsilon of 1e-8 turns that noise into a
  step of ~lr in either direction, in either package, and the running means
  follow those biases.  So the training-mode steps run Adam with eps 10 in
  both packages (noise of <= 0.007 then moves a bias by < 1e-3 lr); the
  frozen-statistics steps, which have no such bias, run the default.

Plus the numpy target helpers (equal), the optimiser schedule (optax's,
the first step at lr 0), the augmentation's invariants, and one
golden-size test (the training script is tests/test_torch_train_script.py): 5 full-batch steps at full width from
``weights/hourglass_fly.npz`` (frozen statistics, lr 1e-4) on 4 golden
images against the JAX trajectory in ``deepfly3d_torch/data/train_fly_k5.npz``
at the tolerances of ``chip_smoke.k5_check`` (regenerate the file with
``python tests/test_torch_train.py --write``, ~2 min).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_tpu.models import train as jax_train
from deepfly3d_torch.models import hourglass as port_hg
from deepfly3d_torch.models import train as port_train

import chip_smoke as smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJECTORY = os.path.join(REPO, "deepfly3d_torch", "data", "train_fly_k5.npz")
SPEC_KW = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=5)
INPUT = (32, 64)
HM = (8, 16)
SPECS = {"conv": {}, "patchify": dict(stem="patchify"), "patch8": dict(stem="patch8"),
         "patch16_subpixel": dict(stem="patch16", head_upsample=2),
         "score3x3": dict(score_ksize=3), "proj_from_raw": dict(proj_from_raw=True)}


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads per test: the suite runs 6 workers on the cores,
    and 8 threads each oversubscribe them (the full-width training steps ran
    25x slower so).  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_variables(spec, seed, moved=True):
    """JAX-initialised variables as numpy, weights and statistics moved off init."""
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(spec, INPUT, jax.random.PRNGKey(seed)))
    if not moved:
        return variables
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
                lambda a: (a + 0.02 * rng.normal(size=a.shape)).astype(np.float32),
                variables["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: np.abs(a + 0.2 * rng.normal(size=a.shape)).astype(np.float32),
                variables["batch_stats"])}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dataset(n, seed=0, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + INPUT + (3,)).astype(np.float32)
    coords = rng.uniform(0.1, 0.9, size=(n, classes, 2))
    peaks = rng.uniform(0.3, 0.9, size=(n, classes))
    known = rng.uniform(size=(n, classes)) > 0.2
    targets, cells = jax_train.render_target_heatmaps(coords, peaks, known, HM)
    return x, targets, cells, peaks.astype(np.float32)


def _vanishing(key: str) -> bool:
    """A conv bias that a batch norm follows on every path: its gradient in
    training mode is zero but for rounding (every bias but the score heads')."""
    return key.endswith("['bias']") and "bn" not in key.split("][")[-2] \
        and "['score" not in key


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trainable_forward_matches_flax(name):
    kw = dict(SPEC_KW, **SPECS[name])
    spec = jax_hg.HourglassSpec(**kw)
    variables = _jax_variables(spec, seed=len(name))
    x = np.random.default_rng(len(name)).uniform(size=(3,) + INPUT + (3,)).astype(np.float32)
    model = jax_hg.HourglassNet(spec)
    want_eval = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    want_train, updates = model.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    net = port_hg.trainable(variables, port_hg.HourglassSpec(**kw), device="cpu")
    with torch.no_grad():
        got_eval = net(torch.from_numpy(x)).numpy()
        got_train = net(torch.from_numpy(x), train=True).numpy()
    assert got_eval.shape == want_eval.shape == (2, 3) + HM + (5,)
    scale = max(1.0, float(np.abs(want_eval).max()))
    np.testing.assert_allclose(got_eval, want_eval, atol=1e-5 * scale, rtol=0)
    want_train = np.asarray(want_train)
    np.testing.assert_allclose(got_train, want_train,
                               atol=3e-5 * max(1.0, float(np.abs(want_train).max())), rtol=0)
    want_stats = _leaves(updates["batch_stats"])
    got_stats = _leaves(port_hg.module_variables(net)["batch_stats"])
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0, err_msg=k,
                                   atol=1e-5 * max(1.0, float(np.abs(want_stats[k]).max())))


def test_carry_over_round_trip_and_refusals():
    spec = port_hg.HourglassSpec(**SPEC_KW)
    variables = _jax_variables(jax_hg.HourglassSpec(**SPEC_KW), seed=1)
    back = _leaves(port_hg.module_variables(port_hg.trainable(variables, spec, device="cpu")))
    want = _leaves(variables)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    del variables["params"]["score0"]
    with pytest.raises(ValueError, match="score0"):
        port_hg.trainable(variables, spec, device="cpu")
    with pytest.raises(ValueError, match="float16"):
        port_hg.HourglassNet(dataclasses.replace(spec, compute_dtype="float16"))


def test_init_params_draws_flax_distributions():
    spec = port_hg.HourglassSpec(**SPEC_KW)
    ours = port_hg.init_params(spec, INPUT, torch.Generator().manual_seed(0), device="cpu")
    theirs = jax_hg.init_params(jax_hg.HourglassSpec(**SPEC_KW), INPUT, jax.random.PRNGKey(0))
    a, b = _leaves(jax.tree_util.tree_map(lambda t: t.numpy(), ours)), _leaves(theirs)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    for k, v in a.items():
        if k.endswith("['kernel']"):
            fan_in = np.prod(v.shape[:3])
            std = np.sqrt(1.0 / fan_in)
            assert np.abs(v).max() <= 2 * std / 0.87962566103423978 + 1e-7, k
            if v.size >= 2000:
                assert abs(v.std() / std - 1.0) < 0.1, k
        else:
            np.testing.assert_array_equal(v, b[k], err_msg=k)     # zeros and ones


# ------------------------------------------------------------- gradient


def _capture_grads():
    """An optax transformation that keeps the gradient as its state and
    updates nothing: one train_epoch step then returns jax.grad of JAX's
    loss_fn as the optimiser state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_loss_gradient_matches_jax(freeze_bn):
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables = _jax_variables(spec, seed=5, moved=freeze_bn)
    x, targets, cells, peaks = _dataset(4, seed=5)
    tx = _capture_grads()
    epoch = jax_train.make_train_epoch(spec, tx, 30.0, 1, 4, freeze_bn=freeze_bn)
    _, _, grads, loss, _, _ = epoch(variables["params"], variables["batch_stats"],
                                    tx.init(variables["params"]), jax.random.PRNGKey(0),
                                    jnp.asarray(x), jnp.asarray(targets), jnp.asarray(cells),
                                    jnp.asarray(peaks))
    want = _leaves(grads)
    net = port_hg.trainable(variables, port_hg.HourglassSpec(**SPEC_KW), device="cpu")
    heatmaps = net(torch.from_numpy(x), train=not freeze_bn)
    got_loss = port_train.loss_terms(heatmaps, torch.from_numpy(targets),
                                     torch.from_numpy(cells).long(), torch.from_numpy(peaks),
                                     30.0, 1.0)[0]
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    got = _leaves(_grad_tree(net))
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * scale, rtol=0, err_msg=k)
        if not freeze_bn and _vanishing(k):      # the noise the K-step tolerance allows for
            assert np.abs(want[k]).max() <= 1e-5 * scale, k


def _grad_tree(net):
    tree = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        g = p.grad.detach()
        if leaf == "weight":
            g = g.permute(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[{"weight": "kernel"}.get(leaf, leaf)] = g.numpy()
    return tree


# ------------------------------------------------------------- K steps


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_train_epoch_k_steps_match_jax(freeze_bn):
    K, LR = 3, 1e-3
    eps = 1e-8 if freeze_bn else 10.0
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables = _jax_variables(spec, seed=7, moved=freeze_bn)
    x, targets, cells, peaks = _dataset(4, seed=7)
    tx = optax.adam(LR, eps=eps)
    epoch = jax_train.make_train_epoch(spec, tx, 30.0, 1, 4, freeze_bn=freeze_bn)
    params, stats, opt = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    want_losses = []
    for k in range(K):
        params, stats, opt, loss, mse, peak_err = epoch(
            params, stats, opt, jax.random.PRNGKey(k), jnp.asarray(x), jnp.asarray(targets),
            jnp.asarray(cells), jnp.asarray(peaks))
        want_losses.append((float(loss), float(mse), float(peak_err)))

    pspec = port_hg.HourglassSpec(**SPEC_KW)
    net = port_hg.trainable(variables, pspec, device="cpu")
    ptx = port_train.adam(LR, eps=eps)
    opt_state = ptx(net.parameters())
    train_epoch = port_train.make_train_epoch(pspec, ptx, 30.0, 1, 4, freeze_bn=freeze_bn)
    rng = torch.Generator().manual_seed(0)
    got_losses = [train_epoch(net, opt_state, rng, torch.from_numpy(x), torch.from_numpy(targets),
                              torch.from_numpy(cells).long(), torch.from_numpy(peaks))
                  for _ in range(K)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = _leaves({"params": params, "batch_stats": stats})
    got = _leaves(port_hg.module_variables(net))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_recalibrate_batch_stats_matches_jax():
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    variables = _jax_variables(spec, seed=9)
    x = _dataset(6, seed=9)[0]
    want = jax_train.recalibrate_batch_stats(variables, spec, x)
    got = port_train.recalibrate_batch_stats(variables, port_hg.HourglassSpec(**SPEC_KW), x,
                                             device="cpu")
    assert got["params"] is variables["params"]
    a, b = _leaves(got["batch_stats"]), _leaves(want["batch_stats"])
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5 * max(1.0, float(np.abs(b[k]).max())),
                                   rtol=0, err_msg=k)


# ------------------------------------------------------------- helpers


@pytest.mark.parametrize("subpixel", [False, True])
def test_render_target_heatmaps_equal(subpixel):
    rng = np.random.default_rng(3)
    coords = rng.uniform(-0.05, 1.05, size=(5, 19, 2))
    peaks = rng.uniform(0.0, 1.0, size=(5, 19))
    known = rng.uniform(size=(5, 19)) > 0.3
    want = jax_train.render_target_heatmaps(coords, peaks, known, (16, 32), 1.25, subpixel)
    got = port_train.render_target_heatmaps(coords, peaks, known, (16, 32), 1.25, subpixel)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_golden_training_targets_equal(golden_2d):
    args = (golden_2d["points2d"], golden_2d["heatmap_confidence"], golden_2d["camera_ordering"])
    for a, b in zip(port_train.golden_training_targets(*args),
                    jax_train.golden_training_targets(*args)):
        np.testing.assert_array_equal(a, b)


def test_schedule_and_first_step_at_lr_zero():
    steps, lr = 40, 2.5e-3
    warmup = min(200, max(steps // 4, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    ours = port_train.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    for count in range(steps + 3):
        np.testing.assert_allclose(ours(count), float(want(count)), rtol=1e-6, atol=1e-12)
    p = torch.nn.Parameter(torch.ones(3))
    opt = port_train.Adam([p], ours)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))               # count 0: lr 0
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - float(want(1)), rtol=1e-6)
    assert opt.state_dict()["param_groups"][0]["count"] == 2


def test_augment_rolls_inputs_targets_and_cells_together():
    x, targets, cells, peaks = _dataset(3, seed=4)
    known = np.ones(cells.shape[:2], bool)
    rng = torch.Generator().manual_seed(1)
    shifts = set()
    for _ in range(12):
        xi, ti, ci = port_train.augment(torch.from_numpy(x), torch.from_numpy(targets),
                                        torch.from_numpy(cells).long(), rng, shift_aug=3)
        k = int(np.argmax([np.array_equal(xi.numpy(), np.roll(x, 4 * s, axis=2))
                           for s in range(-3, 4)])) - 3
        shifts.add(k)
        np.testing.assert_array_equal(xi.numpy(), np.roll(x, 4 * k, axis=2))
        np.testing.assert_array_equal(ti.numpy(), np.roll(targets, k, axis=2))
        # the moved cells are where the rolled targets peak
        coords = (ci.numpy() + 0.0) / np.asarray(HM)
        again, again_cells = port_train.render_target_heatmaps(coords, peaks, known, HM)
        np.testing.assert_array_equal(again_cells, ci.numpy())
        n, kk = np.nonzero(known)
        np.testing.assert_array_equal(ti.numpy()[n, ci[..., 0].numpy()[n, kk],
                                                 ci[..., 1].numpy()[n, kk], kk],
                                      targets[n, cells[n, kk, 0], cells[n, kk, 1], kk])
    assert len(shifts) > 2
    xg, _, _ = port_train.augment(torch.from_numpy(x), torch.from_numpy(targets),
                                  torch.from_numpy(cells).long(), rng, gain_aug=0.05)
    gain = xg.numpy() / np.maximum(x, 1e-6)
    assert np.allclose(gain, gain.flat[0], rtol=1e-5) and abs(gain.flat[0] - 1) <= 0.05
    xn, _, _ = port_train.augment(torch.from_numpy(x), torch.from_numpy(targets),
                                  torch.from_numpy(cells).long(), rng, noise_scale=0.01)
    assert 0 < np.abs(xn.numpy() - x).max() <= 0.01


def test_train_overfit_keep_best_seeded_from_the_resumed_checkpoint():
    spec = port_hg.HourglassSpec(**SPEC_KW)
    variables = _jax_variables(jax_hg.HourglassSpec(**SPEC_KW), seed=2)
    x, targets, cells, peaks = _dataset(4, seed=2)
    calls = []

    def eval_fn(v):                     # every eval after the resumed one is worse
        calls.append(v)
        return {"score": float(len(calls))}

    cfg = port_train.TrainConfig(steps=4, batch_size=4, warmup=1)
    best, history = port_train.train_overfit(x, targets, cells, peaks, spec, cfg,
                                             eval_fn=eval_fn, eval_every=2,
                                             init_variables=variables, keep_best="score",
                                             device="cpu")
    assert len(calls) == 3 and [h["step"] for h in history] == [2, 4]
    a, b = _leaves(best), _leaves(variables)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------- golden size
# The frozen-statistics fine-tune of the training recipe (--resume
# --freeze-bn, its last phase at lr 1e-4) for 5 full-batch steps; the
# inputs, the port's run and the tolerances are chip_smoke.py's (l), which
# holds the card to the same trajectory.


def test_golden_size_five_steps_match_jax_trajectory():
    with np.load(TRAJECTORY) as z:
        ref = {k: z[k] for k in z.files}
    losses, leaves = smoke.k5_trajectory(torch, np, "cpu")
    smoke.k5_check(np, losses, leaves, ref)


def write_trajectory():
    """JAX's 5 steps on the CPU -> deepfly3d_torch/data/train_fly_k5.npz."""
    frames, flips, targets, cells, peaks = smoke.k5_batch(np)
    variables, spec = jax_hg.load_weights(os.path.join(REPO, "weights", "hourglass_fly.npz"))
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    x = jnp.where(jnp.asarray(flips)[:, None, None, None], x[:, :, ::-1, :], x)
    x = jax.image.resize(x, (x.shape[0], 256, 512, 3), method="bilinear")
    tx = optax.adam(smoke.K5_LR)
    epoch = jax_train.make_train_epoch(spec, tx, 100.0, 1, len(frames), freeze_bn=True)
    params, stats, opt = variables["params"], variables["batch_stats"], tx.init(variables["params"])
    losses = []
    for k in range(5):
        params, stats, opt, loss, mse, peak_err = epoch(
            params, stats, opt, jax.random.PRNGKey(k), x, jnp.asarray(targets),
            jnp.asarray(cells), jnp.asarray(peaks))
        losses.append((float(loss), float(mse), float(peak_err)))
    out = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
    np.savez_compressed(TRAJECTORY, losses=np.asarray(losses),
                        **{k: smoke._leaf(np, out, k).astype(np.float32)
                           for k in smoke.K5_LEAVES})
    print(f"wrote {TRAJECTORY}: losses {losses}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        write_trajectory()
