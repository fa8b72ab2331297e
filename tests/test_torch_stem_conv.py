"""The conv stem kernel's contract on the CPU (``ops/kernels.stem_conv``).

The kernel (``csrc/stem_conv.cu``) runs only on a card; here its plain
version is held bit for bit to the convolution, bias and ReLU it replaces,
its packed weights to the folded ones, and its gather (bands of staged input
rows between zero floats, 24 values a kernel row, each lane's k slots two
adjacent floats) and 3xTF32 arithmetic, written out in plain PyTorch, to the
plain version.  The card tests are in ``tests/test_torch_gpu.py``.
"""

import os
import pickle
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import geometry, kernels
from deepfly3d_torch.ops.bottleneck import split_tf32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "weights", "hourglass_fly.npz")
SOURCE = os.path.join(REPO, "deepfly3d_torch", "ops", "csrc", "stem_conv.cu")
LEAD = 12               # floats of a staged row's slot ahead of its band's window


def _stem(cout: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((cout, 3, 7, 7), generator=g) * 0.15
    return w, torch.randn((cout,), generator=g) * 0.1


def _conv_relu(x, w, b):
    """The function the stem kernel replaced: cuDNN's convolution, the
    broadcast bias add and the ReLU."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)
    return torch.relu(y.permute(0, 2, 3, 1) + b)


def _kernel_model(x, w_packed, b, band=None):
    """The kernel's gather and arithmetic in plain PyTorch: an output row cut
    into bands of ``band`` m64 blocks (a whole row by default); for the band
    from output pixel ox0, a slot of ``LEAD + 6 * cols + 8`` floats (cols the
    band's output pixels, rounded up to 4) holds floats ``6 ox0 - LEAD ...``
    of each input row, zero outside the image; output pixel ox of kernel row
    ky reads the 24 floats from ``LEAD + 6 (ox - ox0) - 10`` of the slot of
    input row 2 oy - 3 + ky, in K order; each product x_lo w_hi + x_hi w_lo +
    x_hi w_hi with the TF32 hi and lo halves."""
    n, h, w, _ = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    cout = b.shape[0]
    band = band or -(-wo // 64)
    pitch = -(-(LEAD + 6 * min(wo, 64 * band) + 8) // 4) * 4
    rows = torch.zeros((n, h + 6, 3 * w))                       # input rows -3 ... h + 2
    rows[:, 3:h + 3] = x.reshape(n, h, 3 * w)
    bands = []
    for ox0 in range(0, wo, 64 * band):
        e = 6 * ox0 - LEAD + torch.arange(pitch)
        inside = (e >= 0) & (e < 3 * w)
        slots = torch.zeros((n, h + 6, pitch))
        slots[:, :, inside] = rows[:, :, e[inside]]
        ox = torch.arange(ox0, min(wo, ox0 + 64 * band))
        cols = (LEAD + 6 * (ox - ox0) - 10)[:, None] + torch.arange(kernels.STEM_ROW_K)[None, :]
        assert cols.min() >= 0 and cols.max() < pitch                   # inside the slot
        taps = [slots[:, 2 * torch.arange(ho) + ky][:, :, cols] for ky in range(7)]
        bands.append(torch.stack(taps, dim=3))
    a = torch.cat(bands, dim=2).reshape(n, ho, wo, kernels.STEM_K)      # k = 24 ky + i
    coutp = -(-cout // 8) * 8
    parts = w_packed.reshape(kernels.STEM_K // 8, 2, coutp // 8, 2, 8, 4)
    w_hi, w_lo = (parts[:, j].permute(0, 4, 2, 1, 3).reshape(kernels.STEM_K, coutp)[:, :cout]
                  for j in range(2))
    a_hi, a_lo = split_tf32(a)
    return torch.relu((a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi + b)


@pytest.mark.parametrize("cout,shape", [
    (8, (2, 13, 17, 3)),
    (48, (3, 21, 35, 3)),       # odd H and W: the last column and row half outside
    (48, (2, 24, 40, 3)),
    (10, (1, 9, 11, 3)),        # a width no multiple of 8: padded columns
    (32, (1, 1, 1, 3)),
])
def test_plain_equals_conv_bias_relu_bit_for_bit(cout, shape):
    w, b = _stem(cout, cout)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    want = _conv_relu(x, w, b)
    packed = kernels.pack_stem(w)
    got = kernels.stem_conv_plain(x, packed, b)
    assert got.shape == (shape[0], (shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1, cout)
    assert torch.equal(got, want)
    assert torch.equal(kernels.stem_conv(x, packed, b), want)       # CPU: the plain version


@pytest.mark.parametrize("cout", [8, 10, 32, 48, 64, 128])
def test_packed_weights_round_trip_and_layout(cout):
    w, _ = _stem(cout, 7 + cout)
    packed = kernels.pack_stem(w)
    coutp = -(-cout // 8) * 8
    assert packed.dtype == torch.float32 and packed.numel() == 2 * kernels.STEM_K * coutp
    assert torch.equal(kernels.unpack_stem(packed, cout), w)
    parts = packed.reshape(kernels.STEM_K // 8, 2, -1)
    hi = parts[:, 0].contiguous().view(torch.int32)
    assert not (hi & 0x1FFF).any()                              # hi is a TF32 number
    # k = 8 step + 2 element + half; kernel row ky's values 24 ky + 1 ... 21
    # are its (column, channel) pairs, 24 ky + 0, 22, 23 and the padded
    # columns are zero
    p = packed.reshape(kernels.STEM_K // 8, 2, coutp // 8, 2, 8, 4)
    wk = (p[:, 0] + p[:, 1]).permute(0, 4, 2, 1, 3).reshape(7, kernels.STEM_ROW_K, coutp)
    assert not wk[:, [0, 22, 23]].any() and not wk[..., cout:].any()
    assert torch.equal(wk[:, 1:22, :cout].reshape(7, 7, 3, cout).permute(3, 2, 0, 1), w)


@pytest.mark.parametrize("cout,shape,band", [(48, (2, 20, 36, 3), None),
                                             (32, (1, 11, 9, 3), None),
                                             (64, (1, 7, 130, 3), None),
                                             (8, (1, 5, 301, 3), 1),      # 3 bands, the last ragged
                                             (128, (2, 6, 520, 3), 2)])
def test_kernel_gather_and_arithmetic_match_plain(cout, shape, band):
    """The kernel's index arithmetic on its staged rows, whole or cut into
    bands, gives the plain convolution to float32 rounding (a tap off by one
    pixel or channel would be off by the size of the output)."""
    w, b = _stem(cout, 3 + cout)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(2))
    packed = kernels.pack_stem(w)
    want = kernels.stem_conv_plain(x, packed, b)
    got = _kernel_model(x, packed, b, band)
    assert (got - want).abs().max().item() <= 5e-6 * max(1.0, want.abs().max().item())


def test_instances_and_refusals():
    """Off the CPU the wrapper refuses a Cout that is no instance, naming the
    instances, before it looks for a card (here: tensors on the meta device)."""
    assert kernels.STEM_WIDTHS == (8, 32, 48, 64, 128)
    x = torch.zeros((1, 8, 8, 3), device="meta")
    for cout in (10, 40, 96, 256):
        w = kernels.pack_stem(torch.zeros((cout, 3, 7, 7))).to("meta")
        with pytest.raises(ValueError, match=r"\(8, 32, 48, 64, 128\), not " + str(cout)):
            kernels.stem_conv(x, w, torch.zeros((cout,), device="meta"))
    for cout in kernels.STEM_WIDTHS:
        w = kernels.pack_stem(torch.zeros((cout, 3, 7, 7))).to("meta")
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            kernels.stem_conv(x, w, torch.zeros((cout,), device="meta"))


def test_wrapper_refuses_mixed_devices_and_shapes():
    w, b = _stem(48, 0)
    packed = kernels.pack_stem(w)
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="one device"):
        kernels.stem_conv(x, packed, b.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        kernels.stem_conv(x, packed.to("meta"), b)
    with pytest.raises(ValueError):
        kernels.stem_conv(torch.zeros((1, 8, 8, 4)), packed, b)
    with pytest.raises(ValueError):
        kernels.stem_conv(x, kernels.pack_stem(_stem(32, 0)[0]), b)  # another width's buffer
    with pytest.raises(ValueError):
        kernels.pack_stem(torch.zeros((48, 3, 5, 5)))


def test_kernel_names_stay_out_of_the_roofline_selectors():
    """The stem kernel counts as network glue: its symbols hold none of the
    substrings that select the bottleneck and preprocess rooflines and the
    glue's exclusions."""
    with open(SOURCE) as f:
        text = f.read()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+"      # one level of parentheses
    names = re.findall(r"__global__\s+void\s+(?:" + bounds + r")?(\w+)", text)
    entries = re.findall(r"^int\s+(\w+)\(", text, flags=re.M)
    assert names == ["stem_conv_kernel"]
    assert "df3d_stem_conv" in entries
    for name in names + entries:
        assert not any(s in name for s in ("bottleneck", "preprocess", "upsample2x_add"))


def test_folded_net_runs_the_stem_through_stem_fn():
    """A conv-stem net calls ``stem_fn`` once a forward with its packed
    weights; ``pipeline.plain_twin`` swaps in ``stem_conv_plain``."""
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin

    variables, spec = load_weights(CHECKPOINT)
    folded = fold_hourglass(variables, spec)
    net = FoldedHourglass(folded, spec)
    assert net.stem_fn is kernels.stem_conv
    assert torch.equal(kernels.unpack_stem(net.stem_packed, net.stem_b.shape[0]), net.stem_w)
    seen = []
    net.stem_fn = lambda x, w, b: (seen.append((tuple(x.shape), w is net.stem_packed)),
                                   kernels.stem_conv_plain(x, w, b))[1]
    x = torch.rand((1, 64, 128, 3), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        out = net(x)
    assert seen == [((1, 64, 128, 3), True)] and out.shape == (2, 1, 16, 32, 19)

    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    pipe = build_pipeline(spec, variables, calib, list(range(7)), rig=None, device="cpu")
    twin = plain_twin(pipe)
    assert twin.net.stem_fn is kernels.stem_conv_plain
    assert pipe.net.stem_fn is kernels.stem_conv


@pytest.mark.parametrize("features", [16, 64, 96, 128, 256, 20])
def test_every_conv_stem_runs_the_kernel(tmp_path, features):
    """Every conv stem runs through the kernel's wrapper: Cout = features / 2
    is an instance for every net the port ships (the README's 16-feature toy
    net, the 64-, 96-, 128- and 256-feature nets); another (20 features) runs
    the plain version on the CPU and would be refused on a card."""
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    path = str(tmp_path / "net.npz")
    random_checkpoint(path, 0, num_stacks=1, features=features, depth=1, num_classes=3,
                      input_shape=(32, 64))
    net = FoldedHourglass(*(lambda v, s: (fold_hourglass(v, s), s))(*load_weights(path)))
    assert net.stem_b.shape == (features // 2,) and net.stem_fn is kernels.stem_conv
    assert (features // 2 in kernels.STEM_WIDTHS) == (features != 20)
    with torch.inference_mode():
        out = net(torch.rand((1, 32, 64, 3), generator=torch.Generator().manual_seed(4)))
    assert out.shape == (1, 1, 8, 16, 3)
