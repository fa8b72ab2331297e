"""The port's bfloat16 training against flax's bfloat16 graph, on the CPU.

Tiny specs (16 features, depth 2, 32x64 inputs, as tests/test_torch_train.py),
JAX-initialised weights moved off init and carried over to the port, seeded
numpy inputs.  The reference is flax's graph with every bf16 rounding it
asks for: XLA's jitted bf16 programs skip some of them
(``xla_allow_excess_precision``, on by default), so JAX's jitted bf16
forward differs from its own op-by-op one by about its bf16-vs-float32 gap
(0.032 of the heatmaps' magnitude at the conv spec), while the port computes
the op-by-op graph.  The forwards run op by op; the training step and
``infer_batch`` run jitted with excess precision off (``NO_EXCESS``) at the
patch16 spec, where that program equals the op-by-op one bit for bit (at the
conv spec it still differs by 0.011), and compiles in seconds where op by op
takes minutes.  Tolerances, each a stated fraction of JAX's own
bf16-vs-float32 gap on the same input (``gap``):

* eval-mode forward and the last ``feat_bn`` capture: 1e-3 of the gap
  (measured <= 1.5e-7 of the magnitude: the same roundings);
* train-mode forward: 1.5x the gap, and the running statistics it leaves
  3x (measured up to 0.98x and 1.7x): the batch statistics are float32 sums
  in another order, and a last-bit change of a mean flips bf16 roundings
  downstream, so two bf16 implementations of the train-mode graph lie about
  as far apart as bf16 from float32;
* the loss: 0.1 of the gap (measured 0.055); each gradient leaf within 3x
  its own gap, where the gap is not 0, else equal (measured up to 2.2x: a
  bf16 bias gradient is one rounding of a large sum, 1-2 ulps apart), and
  over all leaves the squared error below the squared gap;
* K frozen-statistics Adam steps at lr 1e-4: the first step's losses (at
  the same weights) within 0.1 of their gap; after an update, within 2e-2 of
  their size (measured 1.0e-2): Adam divides each element's step by its
  gradient's size, so elements whose bf16 gradient is rounding noise step
  by ~lr in a direction the rounding decides, in either package (ROADMAP
  Queue 3), and peak_err follows single cells; every parameter within 2 lr
  per step and within its leaf's gap plus 2 lr;
* the data-parallel step on 2 CPU entries against the one-entry step (Adam
  eps 10, as tests/test_torch_train_parallel.py): losses within 1.5x the
  port's own bf16-vs-float32 gap, since the two sum the statistics in
  another order (as the train-mode forward above), parameters as above;
* the eval path (``infer_batch`` on the unfolded bf16 net against JAX's
  ``infer_batch(fused=False)`` op by op): points and conf within 1e-6 of
  their magnitude.

Plus float16 refused with a ValueError naming it.  Every JAX reference runs
on the spec's shapes of the tests before it where it can: op-by-op JAX
compiles each primitive once per shape.  ~100 s single process.
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
from deepfly3d_tpu.models import inference as jax_inf
from deepfly3d_tpu.models import train as jax_train
from deepfly3d_torch.models import hourglass as port_hg
from deepfly3d_torch.models import train as port_train
from deepfly3d_torch.models.inference import infer_batch
from deepfly3d_torch.parallel import mesh, pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BF16_TRAJECTORY = os.path.join(REPO, "deepfly3d_torch", "data", "train_fly_bf16_k5.npz")
SPEC_KW = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=5)
INPUT = (32, 64)
HM = (8, 16)
SPECS = {"conv": {}, "one_stack": dict(num_stacks=1),
         "patch16_subpixel": dict(stem="patch16", head_upsample=2),
         "score3x3": dict(score_ksize=3), "patchify": dict(stem="patchify")}
DTYPES = ("float32", "bfloat16")
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads per test: the suite runs 6 workers on the cores.
    Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_spec(kw, dtype):
    return jax_hg.HourglassSpec(**kw, compute_dtype=jnp.dtype(dtype).type)


def _variables(kw, seed, moved=True):
    """JAX-initialised variables as numpy, weights and statistics moved off
    init (non-zero biases and means, so the roundings of every bias add show)."""
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hg.init_params(jax_hg.HourglassSpec(**kw), INPUT,
                                       jax.random.PRNGKey(seed)))
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
    return {jax.tree_util.keystr(k): np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + INPUT + (3,)).astype(np.float32)
    coords = rng.uniform(0.1, 0.9, size=(n, 5, 2))
    peaks = rng.uniform(0.3, 0.9, size=(n, 5))
    known = rng.uniform(size=(n, 5)) > 0.2
    targets, cells = jax_train.render_target_heatmaps(coords, peaks, known, HM)
    return x, targets, cells, peaks.astype(np.float32)


def _capture_grads():
    """An optax transformation that keeps the gradient as its state and
    updates nothing (tests/test_torch_train.py)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, updates), updates))


def _grad_tree(net):
    tree = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        g = p.grad.detach().float()
        if leaf == "weight":
            g = g.permute(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[{"weight": "kernel"}.get(leaf, leaf)] = g.numpy()
    return tree


def _within_gap(got, want, other, frac, what):
    """|got - want| <= frac * |want - other| (the max over the array)."""
    err = float(np.abs(got - want).max())
    gap = float(np.abs(want - other).max())
    assert err <= frac * gap, f"{what}: {err} against {frac} x the bf16 gap {gap}"
    return err / gap if gap else 0.0


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bf16_forward_matches_flax(name):
    kw = dict(SPEC_KW, **SPECS[name])
    variables = _variables(kw, seed=len(name))
    x = np.random.default_rng(len(name)).uniform(size=(3,) + INPUT + (3,)).astype(np.float32)
    last_bn = f"feat_bn{kw['num_stacks'] - 1}"
    want = {}
    for dt in DTYPES:
        model = jax_hg.HourglassNet(_jax_spec(kw, dt))
        ev, state = model.apply(variables, jnp.asarray(x), train=False,
                                capture_intermediates=lambda m, _: m.name == last_bn,
                                mutable=["intermediates"])
        bn_out = state["intermediates"][last_bn]["__call__"][0]
        assert bn_out.dtype == jnp.dtype(dt)
        tr, upd = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        want[dt] = (np.asarray(ev), np.asarray(tr), _leaves(upd["batch_stats"]),
                    np.asarray(bn_out.astype(jnp.float32)))
    net = port_hg.trainable(variables, port_hg.HourglassSpec(**kw, compute_dtype="bfloat16"),
                            device="cpu")
    with torch.no_grad():
        got_eval, got_bn = net(torch.from_numpy(x), capture=True)
        got_train = net(torch.from_numpy(x), train=True).numpy()
    assert got_eval.dtype == torch.float32 and got_eval.shape == want["bfloat16"][0].shape
    # the capture: the bf16 value before the ReLU
    assert got_bn.dtype == torch.bfloat16 and (got_bn < 0).any()
    bf, f32 = want["bfloat16"], want["float32"]
    _within_gap(got_eval.numpy(), bf[0], f32[0], 1e-3, "eval")
    _within_gap(got_bn.float().permute(0, 2, 3, 1).numpy(), bf[3], f32[3], 1e-3, last_bn)
    _within_gap(got_train, bf[1], f32[1], 1.5, "train")
    got_stats = _leaves(port_hg.module_variables(net)["batch_stats"])
    assert sorted(got_stats) == sorted(bf[2])
    for k in bf[2]:
        assert got_stats[k].dtype == np.float32
        _within_gap(got_stats[k], bf[2][k], f32[2][k], 3.0, k)


def test_other_dtypes_refused():
    for dtype in ("float16", "float64"):
        with pytest.raises(ValueError, match=dtype):
            port_hg.HourglassNet(port_hg.HourglassSpec(**SPEC_KW, compute_dtype=dtype))


# ------------------------------------------------------------- gradient


def _jax_grads(kw, dt, variables, data, freeze_bn):
    x, targets, cells, peaks = data
    tx = _capture_grads()
    epoch = jax.jit(jax_train.make_train_epoch(_jax_spec(kw, dt), tx, 30.0, 1, len(x),
                                               freeze_bn=freeze_bn), compiler_options=NO_EXCESS)
    _, _, grads, loss, _, _ = epoch(variables["params"], variables["batch_stats"],
                                    tx.init(variables["params"]), jax.random.PRNGKey(0),
                                    jnp.asarray(x), jnp.asarray(targets), jnp.asarray(cells),
                                    jnp.asarray(peaks))
    return float(loss), _leaves(grads)


@pytest.mark.parametrize("name,freeze_bn", [("patch16_subpixel", True),
                                            ("patch16_subpixel", False)])
def test_bf16_loss_gradient_matches_jax(name, freeze_bn):
    kw = dict(SPEC_KW, **SPECS[name])
    variables = _variables(kw, seed=5, moved=freeze_bn)
    data = _dataset(4, seed=5)
    want = {dt: _jax_grads(kw, dt, variables, data, freeze_bn) for dt in DTYPES}
    x, targets, cells, peaks = data
    net = port_hg.trainable(variables, port_hg.HourglassSpec(**kw, compute_dtype="bfloat16"),
                            device="cpu")
    heatmaps = net(torch.from_numpy(x), train=not freeze_bn)
    loss = port_train.loss_terms(heatmaps, torch.from_numpy(targets),
                                 torch.from_numpy(cells).long(), torch.from_numpy(peaks),
                                 30.0, 1.0)[0]
    loss.backward()
    (loss_bf, g_bf), (loss_f32, g_f32) = want["bfloat16"], want["float32"]
    assert abs(loss.item() - loss_bf) <= 0.1 * abs(loss_bf - loss_f32)
    got = _leaves(_grad_tree(net))
    assert sorted(got) == sorted(g_bf)
    sq_err = sq_gap = 0.0
    for k in g_bf:
        _within_gap(got[k], g_bf[k], g_f32[k], 3.0, k)
        sq_err += float(((got[k] - g_bf[k]) ** 2).sum())
        sq_gap += float(((g_bf[k] - g_f32[k]) ** 2).sum())
    assert sq_err < sq_gap


# ------------------------------------------------------------- K steps


def _check_steps(got_losses, got, want_losses, want, other_losses, other, lr, steps, frac,
                 rel_after):
    """The K-step rule (module docstring): the first step's losses within
    ``frac`` of their bf16-vs-float32 gap (plus 1e-6 of their size), the
    later ones within ``rel_after`` of their size where given (else as the
    first), parameters within 2 lr per step and within their leaf's gap
    plus 2 lr."""
    got_losses, want_losses = np.asarray(got_losses), np.asarray(want_losses)
    gap = np.abs(want_losses - np.asarray(other_losses))
    bound = frac * gap + 1e-6 * np.abs(want_losses)
    if rel_after is not None:
        bound[1:] = rel_after * np.abs(want_losses[1:])
    assert (np.abs(got_losses - want_losses) <= bound).all(), \
        (got_losses, want_losses, other_losses)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr * steps + 1e-6, k
        assert diff.max() <= np.abs(want[k] - other[k]).max() + 2 * lr, k


def test_bf16_k_adam_steps_match_jax():
    """3 frozen-statistics Adam steps (lr 1e-4, optax's default eps)."""
    K, LR = 3, 1e-4
    kw = dict(SPEC_KW, **SPECS["patch16_subpixel"])
    variables = _variables(kw, seed=7)
    x, targets, cells, peaks = _dataset(4, seed=5)
    want = {}
    for dt in DTYPES:
        tx = optax.adam(LR)
        epoch = jax.jit(jax_train.make_train_epoch(_jax_spec(kw, dt), tx, 30.0, 1, 4,
                                                   freeze_bn=True), compiler_options=NO_EXCESS)
        params, stats, opt = variables["params"], variables["batch_stats"], \
            tx.init(variables["params"])
        losses = []
        for k in range(K):
            params, stats, opt, loss, mse, peak_err = epoch(
                params, stats, opt, jax.random.PRNGKey(k), jnp.asarray(x),
                jnp.asarray(targets), jnp.asarray(cells), jnp.asarray(peaks))
            losses.append((float(loss), float(mse), float(peak_err)))
        want[dt] = (losses, _leaves({"params": params, "batch_stats": stats}))

    spec = port_hg.HourglassSpec(**kw, compute_dtype="bfloat16")
    net = port_hg.trainable(variables, spec, device="cpu")
    ptx = port_train.adam(LR)
    opt_state = ptx(net.parameters())
    train_epoch = port_train.make_train_epoch(spec, ptx, 30.0, 1, 4, freeze_bn=True)
    rng = torch.Generator().manual_seed(0)
    got_losses = [train_epoch(net, opt_state, rng, torch.from_numpy(x), torch.from_numpy(targets),
                              torch.from_numpy(cells).long(), torch.from_numpy(peaks))
                  for _ in range(K)]
    got = _leaves(port_hg.module_variables(net))
    assert all(v.dtype == np.float32 for v in got.values())
    _check_steps(got_losses, got, *want["bfloat16"], *want["float32"], LR, K, 0.1, 2e-2)


# ------------------------------------------------------------- data parallel


def _port_sharded(entries, dtype, init, steps=2, eps=10.0):
    kw = dict(SPEC_KW, num_stacks=1)
    m = mesh.data_mesh(devices=["cpu"] * entries)
    init_fn, step_fn = pipeline.make_sharded_train_step(
        port_hg.HourglassSpec(**kw, compute_dtype=dtype), m)
    params, stats, opt = init_fn(0, INPUT)
    with torch.no_grad():
        for tree, src in ((params, init["params"]), (stats, init["batch_stats"])):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                node = src
                for p in path:
                    node = node[p.key]
                leaf.copy_(torch.from_numpy(np.array(node)))
    for group in opt.param_groups:
        group["eps"] = eps
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(4,) + INPUT + (3,)).astype(np.float32)
    t = rng.uniform(size=(4,) + HM + (5,)).astype(np.float32)
    losses = []
    for _ in range(steps):
        params, stats, opt, loss = step_fn(params, stats, opt, x, t)
        losses.append([loss.item()])
    return losses, _leaves({"params": params, "batch_stats": stats})


def test_bf16_sharded_step_on_a_cpu_mesh():
    """``make_sharded_train_step`` at bf16 on 2 CPU entries against the
    one-entry step on the whole batch (the statistics are the whole batch's
    in both), held to the port's own bf16-vs-float32 gap; Adam at lr 1e-3, eps 10."""
    init = _variables(dict(SPEC_KW, num_stacks=1), seed=11)
    two = _port_sharded(2, "bfloat16", init)
    one = _port_sharded(1, "bfloat16", init)
    f32 = _port_sharded(1, "float32", init)
    assert all(v.dtype == np.float32 for v in two[1].values())
    _check_steps(*two, *one, *f32, 1e-3, 2, 1.5, None)


# ------------------------------------------------------------- eval path


def test_bf16_eval_path_matches_infer_batch_unfused():
    """uint8 frames -> preprocess -> the unfolded bf16 net in eval mode ->
    argmax decode, against JAX's ``infer_batch(fused=False)`` at bf16."""
    kw = dict(SPEC_KW, **SPECS["patch16_subpixel"])
    variables = _variables(kw, seed=13)
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, size=(3, 48, 96, 3), dtype=np.uint8)
    flips = np.array([False, True, True])
    args = (variables, jnp.asarray(frames), jnp.asarray(flips), _jax_spec(kw, "bfloat16"), INPUT)
    pts, conf = jax_inf.infer_batch.lower(*args, fused=False).compile(NO_EXCESS)(
        *args[:3])
    net = port_hg.trainable(variables, port_hg.HourglassSpec(**kw, compute_dtype="bfloat16"),
                            device="cpu")
    got_pts, got_conf = infer_batch(net, torch.from_numpy(frames), torch.from_numpy(flips), INPUT)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(pts), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(conf), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(conf)).max()))


def test_bf16_spec_field_is_not_a_checkpoint_field(tmp_path):
    """Checkpoints never store compute_dtype: a bf16-trained checkpoint
    reads back as float32 in both packages, as JAX's script writes it."""
    kw = dict(SPEC_KW)
    variables = _variables(kw, seed=2)
    path = str(tmp_path / "bf16.npz")
    port_hg.save_weights(path, variables, port_hg.HourglassSpec(**kw, compute_dtype="bfloat16"))
    assert port_hg.load_weights(path)[1] == port_hg.HourglassSpec(**kw)
    assert jax_hg.load_weights(path)[1].compute_dtype == jnp.float32
    assert dataclasses.replace(port_hg.load_weights(path)[1], compute_dtype="bfloat16") \
        == port_hg.HourglassSpec(**kw, compute_dtype="bfloat16")


# ------------------------------------------------------------- --write


def write_bf16_trajectory():
    """JAX's 5 frozen-statistics steps of the conv checkpoint at bf16 and at
    float32 on the chip smoke run's 4 golden images (``chip_smoke.k5_batch``,
    lr 1e-4), jitted with excess precision off -> BF16_TRAJECTORY."""
    import chip_smoke as smoke

    frames, flips, targets, cells, peaks = smoke.k5_batch(np)
    variables, spec = jax_hg.load_weights(os.path.join(REPO, "weights", "hourglass_fly.npz"))
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    x = jnp.where(jnp.asarray(flips)[:, None, None, None], x[:, :, ::-1, :], x)
    x = jax.image.resize(x, (x.shape[0], 256, 512, 3), method="bilinear")
    out = {}
    for dt in DTYPES:
        tx = optax.adam(smoke.K5_LR)
        epoch = jax.jit(jax_train.make_train_epoch(
            dataclasses.replace(spec, compute_dtype=jnp.dtype(dt).type), tx, 100.0, 1,
            len(frames), freeze_bn=True), compiler_options=NO_EXCESS)
        params, stats, opt = variables["params"], variables["batch_stats"], \
            tx.init(variables["params"])
        losses = []
        for k in range(5):
            params, stats, opt, loss, mse, peak_err = epoch(
                params, stats, opt, jax.random.PRNGKey(k), x, jnp.asarray(targets),
                jnp.asarray(cells), jnp.asarray(peaks))
            losses.append((float(loss), float(mse), float(peak_err)))
        tree = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
        out[f"{dt}/losses"] = np.asarray(losses)
        out.update({f"{dt}/{k}": smoke._leaf(np, tree, k).astype(np.float32)
                    for k in smoke.K5_LEAVES})
        print(dt, losses, flush=True)
    np.savez_compressed(BF16_TRAJECTORY, **out)
    print(f"wrote {BF16_TRAJECTORY}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        write_bf16_trajectory()
