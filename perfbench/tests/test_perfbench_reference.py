"""The plain reference against the program's plain path, at test sizes on the CPU."""

import numpy as np
import pytest
import torch

from deepfly3d_torch.models.convert_torch import convert_state_dict
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import HourglassSpec, load_weights
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.pipeline import plain_twin
from deepfly3d_torch.utils import synthetic
from builders import seeded_torch
from reference import hourglass, pipeline as ref

SPEC = dict(num_stacks=2, features=16, depth=3, num_blocks=1, num_classes=19, stem="conv",
            stem_channels=[8, 16, 16], input_shape=[64, 128])


def _heatmaps(net, x):
    with torch.no_grad():
        return net.forward(x)


@pytest.mark.parametrize("layout", ["flax", "torch", "torch_published_stem"])
def test_reference_network_matches_the_folded_forward(tmp_path, layout):
    arrays = synthetic.random_checkpoint(str(tmp_path / "w.npz"), 3, 2, 16, 3, 19, (64, 128))
    x = torch.from_numpy(np.random.default_rng(0).random((2, 64, 128, 3), np.float32))
    raw = layout != "flax"
    if raw:
        if layout == "torch":
            sd = synthetic.torch_state_dict(arrays, 2, 3)
        else:       # the published stem's widths, as the 256-wide configuration's builder makes it
            sd = {k: v.numpy() for k, v in seeded_torch.state_dict(
                dict(SPEC, stem_channels=[4, 8, 8]), 5, torch.device("cpu")).items()}
        spec = HourglassSpec(num_stacks=2, features=16, depth=3, proj_from_raw=True)
        params, stats = convert_state_dict(sd, spec)
        variables = {"params": params, "batch_stats": stats}
        layout = hourglass.TorchLayout({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    else:
        variables, spec = load_weights(str(tmp_path / "w.npz"))
        layout = hourglass.FlaxLayout({k: torch.from_numpy(v) for k, v in arrays.items()})
    port = plain_twin_net(FoldedHourglass(fold_hourglass(variables, spec), spec))
    with torch.no_grad():
        want = port(x)[-1].permute(0, 3, 1, 2)
    got = _heatmaps(hourglass.Hourglass(layout, SPEC, raw), x.permute(0, 3, 1, 2))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-5 * float(want.abs().max())


def plain_twin_net(net):
    from deepfly3d_torch.ops.bottleneck import bottleneck_plain
    from deepfly3d_torch.ops.kernels import upsample2x_add_plain

    net.block_fn, net.merge_fn = bottleneck_plain, upsample2x_add_plain
    return net.eval()


def test_reference_call_matches_the_pipelines_plain_twin():
    """Registration, preprocess, decode, assembly and DLT of a drifted chunk."""
    import harness
    import generator
    from conftest import tiny_cell

    cell = tiny_cell("df2d256.dev_T16", T=2, chunks=1, features=16, depth=3,
                     stem_channels=[4, 8, 8], input_shape=[64, 128])
    dev = torch.device("cpu")
    rec = generator.source(cell.mix).load(harness.ROOT)
    chunk = generator.make_pool(torch.from_numpy(rec), cell.mix, 7)[0]
    made = harness.builder(cell.cfg).make(cell.cfg, harness.ROOT, 7, dev)
    pipe = plain_twin(cell.entry.build(cell, harness.ROOT, made, dev))
    p3d, p38, conf = (t.numpy() for t in pipe(chunk))
    rig = ref.load_rig(cell.cfg, harness.ROOT)
    net = hourglass.Hourglass(made["layout"], cell.cfg["spec"], True)
    r = ref.run(chunk, net, rig, tuple(cell.cfg["image_hw"]))
    assert (r.dy != 0).any() or (r.dx != 0).any()
    assert np.abs(conf - r.conf).max() < 1e-5
    assert np.array_equal(p38, r.points2d)
    tri, sep = ref.triangulate(r.points2d - ref.observed(r.points2d)[..., None]
                               * ref.offsets(r.dy, r.dx, (480, 960))[:, None, None], rig, (480, 960))
    posed = sep >= 4
    assert posed.any()
    assert np.abs(p3d - tri)[posed].max() < 1e-4 * np.abs(tri[posed]).max()


def test_reference_dlt_recovers_a_projected_point():
    rig = ref.load_rig({"rig_template": "weights/rig_template_fly.npz", "calib": "data/calib.pkl",
                        "num_cameras": 7, "camera_ordering": list(range(7)),
                        "spec": {"input_shape": [256, 512]}}, _root())
    X = np.array([0.1, -0.2, 0.3])
    P = rig.intr.astype(np.float64) @ np.concatenate([rig.R, rig.tvec[..., None]], axis=-1)
    uvw = P @ np.append(X, 1.0)
    xy = uvw[:, :2] / uvw[:, 2:]
    p38 = np.zeros((7, 1, 38, 2))
    p38[:, 0, 0] = np.stack([xy[:, 1] / 480, xy[:, 0] / 960], axis=-1)
    points, sep = ref.triangulate(p38, rig, (480, 960))
    assert np.allclose(points[0, 0], X, atol=1e-9)
    assert np.isinf(sep[0, 1]) and (points[0, 1:] == 0).all()
    port = geometry.triangulate(torch.from_numpy(p38), torch.from_numpy(rig.R.astype(np.float64)),
                                torch.from_numpy(rig.tvec.astype(np.float64)),
                                torch.from_numpy(rig.intr.astype(np.float64)), (960, 480),
                                method="svd").numpy()
    assert np.allclose(port[0, 0], X, atol=1e-9)


def _root():
    import harness

    return harness.ROOT
