"""The port's data-parallel train step against the JAX package's, on the CPU.

``make_sharded_train_step`` on a mesh of 8 ``cpu`` entries against JAX's
``step_fn`` on its 8 virtual devices (tests/conftest.py), and against the
port's own one-entry step on the whole batch: the batch norms' statistics
are the whole batch's in every case, so the three compute one function.
Seeded non-zero inputs, two steps of Adam (eps 10 in all three, as in
tests/test_torch_train.py: at the default 1e-8 Adam turns the rounding
noise in the gradients of the biases that a batch norm follows into
steps of ~lr in either direction).  Tolerances: losses rtol 1e-5,
parameters and statistics 1e-5 absolute.  A mesh of per-shard statistics
(each entry its own batch norm) computes another function, which the
test shows too.  Plus JAX's own zero-input check (tests/test_sharding.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_tpu.parallel import mesh as jax_mesh
from deepfly3d_tpu.parallel import pipeline as jax_pipeline
from deepfly3d_torch.models import hourglass as port_hg
from deepfly3d_torch.parallel import mesh
from deepfly3d_torch.parallel import pipeline

SPEC_KW = dict(num_stacks=2, features=16, depth=2, num_blocks=1, num_classes=5)
INPUT = (32, 64)
EPS = 10.0
STEPS = 2


@pytest.fixture(autouse=True)
def _few_threads():
    """1 intra-op thread per test: the suite runs 6 workers on the cores,
    and 8 threads each oversubscribe them (the full-width training steps ran
    25x slower so).  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _data():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(8,) + INPUT + (3,)).astype(np.float32)
    t = rng.uniform(size=(8, 8, 16, 5)).astype(np.float32)
    return x, t


@pytest.fixture(scope="module")
def jax_run(monkeypatch_module):
    """JAX's step on 8 virtual devices: its init, and after STEPS steps."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    real_adam = optax.adam
    monkeypatch_module.setattr(optax, "adam", lambda lr: real_adam(lr, eps=EPS))
    x, t = _data()
    jm = jax_mesh.data_mesh(8)
    spec = jax_hg.HourglassSpec(**SPEC_KW)
    with jm:
        init_fn, step_fn = jax_pipeline.make_sharded_train_step(spec, jm)
        params, stats, opt = init_fn(jax.random.PRNGKey(0), INPUT)
        init = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
        losses = []
        for _ in range(STEPS):
            params, stats, opt, loss = step_fn(params, stats, opt,
                                               jax_mesh.shard_batch(jm, jnp.asarray(x)),
                                               jax_mesh.shard_batch(jm, jnp.asarray(t)))
            losses.append(float(loss))
    return init, losses, jax.tree_util.tree_map(np.asarray,
                                                {"params": params, "batch_stats": stats})


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port_run(devices, init, eps=EPS):
    """The port's step on ``devices`` from JAX's initial variables."""
    m = mesh.data_mesh(devices=devices)
    init_fn, step_fn = pipeline.make_sharded_train_step(port_hg.HourglassSpec(**SPEC_KW), m)
    params, stats, opt = init_fn(0, INPUT)
    with torch.no_grad():
        for tree, src in ((params, init["params"]), (stats, init["batch_stats"])):
            for (path, leaf) in jax.tree_util.tree_flatten_with_path(tree)[0]:
                node = src
                for p in path:
                    node = node[p.key]
                leaf.copy_(torch.from_numpy(np.array(node)))
    for group in opt.param_groups:
        group["eps"] = eps
    x, t = _data()
    losses = []
    for _ in range(STEPS):
        params, stats, opt, loss = step_fn(params, stats, opt, x, t)
        losses.append(loss.item())
    return losses, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """The port's step from JAX's initial variables on 8 and on 1 cpu entries."""
    return {n: _port_run(["cpu"] * n, jax_run[0]) for n in (8, 1)}


def _assert_close(got, want):
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("entries", [8, 1])
def test_sharded_train_step_matches_jax(jax_run, port_runs, entries):
    _, want_losses, want = jax_run
    losses, got = port_runs[entries]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_close(got, want)


def test_eight_entries_equal_one_entry_on_the_whole_batch(port_runs):
    (losses8, got8), (losses1, got1) = port_runs[8], port_runs[1]
    np.testing.assert_allclose(losses8, losses1, rtol=1e-5)
    _assert_close(got8, got1)


def test_per_shard_statistics_would_compute_another_function(jax_run, port_runs):
    """The eight shards' own statistics (no exchange) give another loss."""
    init = jax_run[0]
    spec = port_hg.HourglassSpec(**SPEC_KW)
    net = port_hg.trainable(init, spec, device="cpu")
    x, t = _data()
    with torch.no_grad():
        whole = ((net(torch.from_numpy(x), train=True) - torch.from_numpy(t)[None]) ** 2).mean()
        shards = torch.stack([((net(torch.from_numpy(x[i:i + 1]), train=True)
                                - torch.from_numpy(t[i:i + 1])[None]) ** 2).mean()
                              for i in range(8)]).mean()
    np.testing.assert_allclose(port_runs[8][0][0], whole.item(), rtol=1e-5)
    assert abs(shards.item() - whole.item()) > 1e-3 * whole.item()


def test_sharded_train_step_zero_input_loss_does_not_increase():
    """tests/test_sharding.py's check: zeros in, zero targets, two steps."""
    m = mesh.data_mesh(devices=["cpu"] * 8)
    spec = port_hg.HourglassSpec(num_stacks=2, features=16, depth=2, num_classes=19)
    init_fn, step_fn = pipeline.make_sharded_train_step(spec, m)
    params, stats, opt = init_fn(torch.Generator().manual_seed(0), INPUT)
    images = np.zeros((8,) + INPUT + (3,), np.float32)
    targets = np.zeros((8, 8, 16, 19), np.float32)
    params, stats, opt, loss = step_fn(params, stats, opt, images, targets)
    params, stats, opt, loss2 = step_fn(params, stats, opt, images, targets)
    assert np.isfinite(loss.item()) and np.isfinite(loss2.item())
    assert loss2.item() <= loss.item()


def test_an_entry_that_fails_frees_the_others(monkeypatch):
    """An entry that raises before a barrier aborts it: the step raises its
    error instead of leaving the other entries waiting."""
    import threading

    m = mesh.data_mesh(devices=["cpu"] * 4)
    init_fn, step_fn = pipeline.make_sharded_train_step(port_hg.HourglassSpec(**SPEC_KW), m)
    params, stats, opt = init_fn(0, INPUT)
    x, t = _data()
    moments = pipeline._Member.moments

    def failing(self, v):
        if self.rank == 2 and self.calls == 3:
            raise RuntimeError("entry 2 fails")
        return moments(self, v)

    monkeypatch.setattr(pipeline._Member, "moments", failing)
    raised = []

    def call():
        try:
            step_fn(params, stats, opt, x[:4], t[:4])
        except RuntimeError as e:
            raised.append(str(e))

    worker = threading.Thread(target=call)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and raised == ["entry 2 fails"]


def test_grid_mesh_replicas_compute_the_same_step():
    """On a ('data', 'time') mesh the batch splits over 'data' and the entries
    along 'time' hold copies: the step equals the 1-D mesh's."""
    spec = port_hg.HourglassSpec(**SPEC_KW)
    x, t = _data()
    out = {}
    for name, m in (("data", mesh.data_mesh(devices=["cpu"] * 2)),
                    ("grid", mesh.grid_mesh((2, 2), ("data", "time"), devices=["cpu"] * 4))):
        init_fn, step_fn = pipeline.make_sharded_train_step(spec, m)
        params, stats, opt = init_fn(0, INPUT)
        for group in opt.param_groups:
            group["eps"] = EPS
        params, stats, opt, loss = step_fn(params, stats, opt, x[:4], t[:4])
        out[name] = (loss.item(), _leaves({"params": params, "batch_stats": stats}))
    np.testing.assert_allclose(out["grid"][0], out["data"][0], rtol=1e-5)
    for k, v in out["data"][1].items():
        np.testing.assert_allclose(out["grid"][1][k], v, atol=1e-5, rtol=0, err_msg=k)
