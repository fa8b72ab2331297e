"""The frozen counts: FLOPs against torch's counter over the reference, bytes by hand."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import yardstick
from builders.seeded_torch import _entries
from reference import hourglass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _meta_layout(cfg):
    """The configuration's weights as shapes only (meta tensors)."""
    if cfg["builder"] == "seeded_torch":
        return hourglass.TorchLayout({n: torch.empty(s, device="meta")
                                      for n, s, _, _ in _entries(cfg["spec"])})
    with np.load(os.path.join(ROOT, cfg["checkpoint"])) as z:
        return hourglass.FlaxLayout({k: torch.empty(z[k].shape, device="meta")
                                     for k in z.files if not k.startswith("__spec__/")})


@pytest.mark.parametrize("name", ["fly_conv", "df2d256"])
def test_forward_flops_equal_torchs_count_over_the_reference(name):
    cfg = _config(name)
    spec, shape = cfg["spec"], tuple(cfg["spec"]["input_shape"])
    net = hourglass.Hourglass(_meta_layout(cfg), spec, spec["proj_from_raw"])
    with FlopCounterMode(display=False) as counter:
        net.forward(torch.empty((3, 3) + shape, device="meta"))
    counted = yardstick.forward_flops(spec, 3, shape)
    assert counter.get_total_flops() == counted["total"] - counted["adds"]


@pytest.mark.parametrize("name", ["fly_conv", "df2d256"])
def test_frozen_counts_equal_the_programs(name):
    from deepfly3d_torch import bench
    from deepfly3d_torch.models.hourglass import HourglassSpec

    cfg = _config(name)
    s = cfg["spec"]
    spec = HourglassSpec(num_stacks=s["num_stacks"], features=s["features"], depth=s["depth"],
                         num_blocks=s["num_blocks"], num_classes=s["num_classes"])
    shape = tuple(s["input_shape"])
    # the program counts the stem of its own spec, [features / 2, features, features]
    f = s["features"]
    own_stem = dict(s, stem_channels=[f // 2, f, f])
    assert yardstick.forward_flops(own_stem, 224, shape) == bench.forward_flops(spec, 224, shape)
    assert yardstick.preprocess_flops(224, (480, 960), shape) == \
        bench.preprocess_flops(224, (480, 960), shape)
    assert len(yardstick.blocks(s, shape)) == 31


def test_one_block_by_hand():
    b = yardstick.Block(h=2, w=3, cin=4, cout=8)                 # mid 4, projecting
    # per pixel 4*4 + 9*4*4 + 4*8 + 4*8 = 224 multiply-adds; 6 pixels
    assert yardstick.block_flops(*b) == 2 * 6 * 224
    # n=5: x 5*6*4 and y 5*6*8 floats, weights 224, vectors s1 t1 (4+4) b1 b2 (4+4) b3 bp (8+8)
    assert yardstick.block_bytes(b, 5) == 4 * (5 * 6 * 12 + 224 + 32)
    seconds, by = yardstick.bound_s(5 * 2688, 4 * (360 + 224 + 32), "float32")
    assert by == "bytes" and seconds == pytest.approx(2464 / 3.35e12)
    seconds, by = yardstick.bound_s(1e12, 1e3, "float32")
    assert by == "ops" and seconds == pytest.approx(1e12 / 495e12)


def test_preprocess_taps_and_bytes():
    from deepfly3d_torch.ops.image import resize_taps

    for n_in, n_out in ((480, 256), (960, 512), (1000, 384)):
        assert yardstick.resize_taps_width(n_in, n_out) == resize_taps(n_in, n_out)[1].shape[1]
    assert yardstick.preprocess_bytes(2, (480, 960), (256, 512)) == \
        2 * (480 * 960 * 3 + 256 * 512 * 3 * 4)
