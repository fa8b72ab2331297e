"""Port's folded hourglass forward vs the JAX package's, on the CPU.

A small spec (16 features, depth 2, 2 stacks so the re-injection between
stacks is covered) with JAX-initialised weights and batch statistics moved
away from their init, so every fold is exercised.  Each stack's heatmaps
are compared with the JAX folded forward ``fused_apply`` (atol 1e-5) and
with the flax graph ``HourglassNet.apply(train=False)`` (atol 1e-4, the
precedent of tests/test_convert_torch_forward.py).  Plus the decoded
points of the last stack.
"""

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
