"""The frozen counts: FLOPs against torch's counter over the reference, bytes by hand.

The counted cases are BENCHMARK.json's configurations, each with its weights'
shapes from its builder (``shapes``), its frame size, and the images a call
of each of its cells takes (the mix's ``T`` times the configuration's cameras).
"""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
import yardstick
from reference import hourglass

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CONFIGS = [c["name"] for c in _bench()["configs"]]


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _images(name):
    """The images one call takes in each cell of the configuration ``name``."""
    cfg = _config(name)
    return sorted({harness.load_cell(w["name"]).mix["T"] * cfg["num_cameras"]
                   for w in _bench()["workloads"] if w["config"] == name})


def _reference_net(cfg):
    layout = harness.builder(cfg).shapes(cfg, ROOT)
    return hourglass.Hourglass(layout, cfg["spec"], cfg["spec"]["proj_from_raw"])


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_equal_torchs_count_over_the_reference(name):
    cfg = _config(name)
    spec, shape = cfg["spec"], tuple(cfg["spec"]["input_shape"])
    net = _reference_net(cfg)
    with FlopCounterMode(display=False) as counter:
        net.forward(torch.empty((3, 3) + shape, device="meta"))
    counted = yardstick.forward_flops(spec, 3, shape)
    assert counter.get_total_flops() == counted["total"] - counted["adds"]


@pytest.mark.parametrize("name", CONFIGS)
def test_blocks_are_the_references(name):
    """``yardstick.blocks``, in launch order, is every block the reference's
    forward runs: its map and its widths."""
    cfg = _config(name)
    shape = tuple(cfg["spec"]["input_shape"])
    net = _reference_net(cfg)
    ran, block = [], net.block

    def counted(x, which):
        y = block(x, which)
        ran.append(yardstick.Block(x.shape[2], x.shape[3], x.shape[1], y.shape[1]))
        return y

    net.block = counted
    net.forward(torch.empty((1, 3) + shape, device="meta"))
    assert yardstick.blocks(cfg["spec"], shape) == ran


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_counts_equal_the_programs(name):
    from deepfly3d_torch import bench
    from deepfly3d_torch.models.hourglass import HourglassSpec
    from deepfly3d_torch.ops.image import resize_taps

    cfg = _config(name)
    s = cfg["spec"]
    spec = HourglassSpec(num_stacks=s["num_stacks"], features=s["features"], depth=s["depth"],
                         num_blocks=s["num_blocks"], num_classes=s["num_classes"])
    shape, hw = tuple(s["input_shape"]), tuple(cfg["image_hw"])
    # the program counts the stem of its own spec, [features / 2, features, features]
    f = s["features"]
    own_stem = dict(s, stem_channels=[f // 2, f, f])
    for n_in, n_out in zip(hw, shape):
        assert yardstick.resize_taps_width(n_in, n_out) == resize_taps(n_in, n_out)[1].shape[1]
    assert _images(name)
    for n in _images(name):
        assert yardstick.forward_flops(own_stem, n, shape) == bench.forward_flops(spec, n, shape)
        assert yardstick.preprocess_flops(n, hw, shape) == bench.preprocess_flops(n, hw, shape)


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


def test_the_fly_forward_by_hand():
    """31 blocks: the stem's 3, and 14 a stack (3 a level of depth 4, the
    innermost, the feature block)."""
    spec = dict(num_stacks=2, features=96, depth=4, num_blocks=1, stem="conv",
                stem_channels=[48, 96, 96])
    assert len(yardstick.blocks(spec, (256, 512))) == 3 + 2 * (3 * 4 + 1 + 1)


def test_preprocess_taps_and_bytes():
    from deepfly3d_torch.ops.image import resize_taps

    for n_in, n_out in ((480, 256), (960, 512), (1000, 384)):
        assert yardstick.resize_taps_width(n_in, n_out) == resize_taps(n_in, n_out)[1].shape[1]
    assert yardstick.preprocess_bytes(2, (480, 960), (256, 512)) == \
        2 * (480 * 960 * 3 + 256 * 512 * 3 * 4)
