"""The port's CUDA kernels vs their plain versions, on a card.

Marked ``gpu``: on a machine without a CUDA device every test skips (the
decision is made inside each test, so every pytest worker collects the
same tests).  Run on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Tolerances: the bottleneck computes its ~500-term sums as error-compensated
TF32 products on the tensor cores, in another order than cuDNN/cuBLAS, so
its error against the plain version and against its own arithmetic model
(``bottleneck_tf32_model``) is held to 5e-5 of the output's largest
magnitude; the general instance (any width of the envelope, every weight
streamed) to the same, and at bf16 to 2 bf16 ulps; a width past the
envelope raises.  The conv stem kernel sums 147 products as the same
3xTF32 and is held to the same 5e-5, and so is the head kernel (96 and 24
products a chained 1x1 head).  The upsample-add and the decode are
exact (NaN and signed zeros included).  The preprocess sums
<= 25 products in another order than cuBLAS: 2e-6 on [0, 1] values when it
resizes (times the largest gain when the rig registration's gain is folded
in), exact in identity mode (out shape == in shape, the TPU kernel's
function); with the registration's shift and gain it must equal, bit for
bit, the kernel on ``apply_shift_tc``'s frames times the gain.  The p16 and
cascade pipelines, and the conv pipeline on drifted frames, must match their
plain twins (``pipeline.plain_twin``): p38 equal, conf within 1e-4, points3d
within 1e-5 relative.  The estimator's ingest loop on the card must give what
it gives on the CPU: points equal, conf within 2e-5.  The soft-argmax decode
on the card (its cells from the decode kernel) must give the CPU's cells and
conf and points within 1e-5.
"""

import copy
import ctypes
import os
import pickle

import numpy as np
import pytest
import torch

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import _build
from deepfly3d_torch.ops import bottleneck as bn
from deepfly3d_torch.ops import canonicalize, geometry
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.ops import kernels
from deepfly3d_torch.utils.devices import full_f32

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "weights", "hourglass_fly.npz")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    full_f32()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def blocks():
    variables, spec = load_weights(CHECKPOINT)
    return fold_hourglass(variables, spec)["blocks"]


@pytest.fixture(scope="module")
def fly64_blocks(tmp_path_factory):
    """A 64-feature fly network's folded blocks (32->32->64 with projection,
    64->32->64), weights from a seed."""
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    path = str(tmp_path_factory.mktemp("fly64") / "fly64.npz")
    random_checkpoint(path, 1, num_stacks=1, features=64, depth=1, num_classes=19,
                      input_shape=(64, 64))
    return fold_hourglass(*load_weights(path))["blocks"]


@pytest.mark.parametrize("name,shape,b1_positive,raw", [
    ("stem_res1", (2, 128, 256, 48), False, False),
    ("stem_res2", (3, 64, 128, 96), False, False),
    ("hg0/down_d1_0", (5, 4, 8, 96), False, False),
    ("hg1/skip_d2_0", (2, 13, 21, 96), False, False),   # tiles cut by the image edge
    ("stem_res1", (7, 128, 256, 48), False, False),     # the projection block at the teacher's batch
    ("stem_res1", (1, 19, 37, 48), False, False),       # projection, tiles cut by the image edge
    ("hg0/innermost_0", (56, 3, 6, 96), False, False),  # the patchify student's odd innermost level
    ("hg0/innermost_0", (56, 2, 4, 96), False, False),  # p16's innermost level
    ("hg0/up_d3_0", (7, 16, 32, 96), False, False),     # small batch: thin tiles
    ("feat_res0", (1, 1, 1, 96), False, False),
    ("stem_res1", (224, 128, 256, 48), False, False),   # the benchmark's T=32 call: the stem block
    ("stem_res2", (224, 64, 128, 96), False, False),    # ... and the trunk
    ("stem_res2", (224, 19, 37, 96), True, False),      # ragged tiles at N=224, b1 > 0
    ("stem_res2", (1, 13, 21, 96), True, False),        # ragged, N=1
    ("hg0/skip_d1_0", (7, 33, 70, 96), True, False),    # ragged, N=7
    ("stem_res1", (1, 17, 33, 48), True, False),        # ragged projection, b1 > 0
    ("stem_res1", (7, 128, 256, 48), True, True),       # the raw projection at the stem shape
    ("stem_res1", (224, 13, 21, 48), False, True),      # raw, ragged, N=224
    ("fly64:stem_res1", (7, 128, 256, 32), False, False),   # the 64-feature net's instances
    ("fly64:stem_res1", (1, 19, 37, 32), True, True),
    ("fly64:stem_res2", (224, 64, 128, 64), False, False),
    ("fly64:stem_res2", (7, 13, 21, 64), True, False),
])
def test_bottleneck_kernel_matches_plain(blocks, fly64_blocks, name, shape, b1_positive, raw):
    """The fly float32 instances (csrc/bottleneck.cu: w1, w3 and wp resident,
    w2 streamed through an mbarrier ring, wgmma 3xTF32) against the plain
    version and the TF32 model; a positive b1 shows whether the 3x3's zero
    padding is a2's (relu(b1) would not be 0); counted under ``launches``;
    their shared-memory figure is the wrapper's."""
    dev = _card()
    block = fly64_blocks[name[6:]] if name.startswith("fly64:") else blocks[name]
    block = {k: v for k, v in block.items() if k != "packed"}
    if b1_positive:
        block["b1"] = block["b1"].abs() + 0.5
    if raw:
        block["proj_raw"] = torch.ones((), dtype=torch.bool)
    folded = {k: v.to(dev) for k, v in bn.add_packed(block).items()}
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(dev)
    before = bn.fused_bottleneck.launches
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    assert bn.fused_bottleneck.launches == before + 1
    want = bn.bottleneck_plain(x, folded)
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol
    # the wrapper's shared-memory budget and packed size are the kernel's own figures
    n, h, w, cin = shape
    cmid, cout, proj = folded["w1"].shape[1], folded["w3"].shape[1], "wp" in folded
    args = (cin, cmid, cout, *bn.choose_tile(n, h, w, cin, cmid, cout, proj), int(proj))
    lib = _build.library("bottleneck")
    lib.df3d_bottleneck_smem.argtypes = [ctypes.c_int] * 6
    lib.df3d_bottleneck_smem.restype = ctypes.c_size_t
    assert lib.df3d_bottleneck_smem(*args) == bn.smem_bytes(*args[:5], proj)
    lib.df3d_bottleneck_packed_bytes.argtypes = [ctypes.c_int] * 4
    lib.df3d_bottleneck_packed_bytes.restype = ctypes.c_int
    assert lib.df3d_bottleneck_packed_bytes(cin, cmid, cout, int(proj)) == \
        4 * bn.packed_size(cin, cmid, cout, proj)


@pytest.fixture(scope="module")
def wide_blocks(tmp_path_factory):
    """The 128-wide h36m network's folded blocks, weights from a seed."""
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    path = str(tmp_path_factory.mktemp("h36m") / "h36m.npz")
    random_checkpoint(path, 0, num_stacks=1, features=128, depth=1, num_classes=17,
                      input_shape=(64, 64))
    return fold_hourglass(*load_weights(path))["blocks"]


@pytest.mark.parametrize("name,shape,b1_positive", [
    ("stem_res1", (8, 192, 192, 64), False),     # the projecting stem block of the h36m path
    ("stem_res1", (3, 19, 37, 64), False),       # tiles cut by the image edge
    ("stem_res2", (8, 96, 96, 128), False),
    ("stem_res2", (8, 12, 12, 128), False),
    ("hg0/innermost_0", (8, 6, 6, 128), False),
    ("hg0/innermost_0", (5, 13, 21, 128), False),
    ("feat_res0", (1, 1, 1, 128), False),        # the 1x1 image: one tile, every tap but one padding
    ("stem_res2", (16, 96, 96, 128), False),     # more tiles than SMs x ring slots: phases wrap
    ("stem_res1", (6, 48, 48, 64), False),
    ("stem_res2", (4, 19, 37, 128), True),       # b1 > 0: the 3x3's zero padding is a2's
    ("stem_res1", (2, 24, 24, 64), True),
])
def test_streamed_bottleneck_matches_plain(wide_blocks, name, shape, b1_positive):
    """The 128-wide instances (csrc/bottleneck_128.cu: w1 and w3 resident, w2
    and wp streamed through an mbarrier ring, wgmma 3xTF32); held to the
    resident instances' tolerance, counted under ``launches_128``, and their
    shared-memory figure is the wrapper's."""
    dev = _card()
    block = wide_blocks[name]
    if b1_positive:     # a positive b1 makes relu(b1) != 0: padding with it would show
        block = {**{k: v for k, v in block.items() if k != "packed"},
                 "b1": block["b1"].abs() + 0.5}
    folded = {k: v.to(dev) for k, v in bn.add_packed(block).items()}
    cin, cmid, cout, proj = shape[3], folded["w1"].shape[1], folded["w3"].shape[1], \
        "wp" in folded
    assert bn.streams_w2(cin, cmid, cout, proj)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=g).to(dev)
    before = (bn.fused_bottleneck.launches, bn.fused_bottleneck.launches_128)
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    assert (bn.fused_bottleneck.launches, bn.fused_bottleneck.launches_128) == \
        (before[0], before[1] + 1)
    want = bn.bottleneck_plain(x, folded)
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol
    n, h, w, _ = shape
    th, tw = bn.choose_tile(n, h, w, cin, cmid, cout, proj)
    if n == 16:
        tiles = n * -(-h // th) * -(-w // tw)
        assert tiles > bn.NUM_SMS * bn._layout_128(cin, th, tw, proj)[1]
    smem = _build.library("bottleneck_128").df3d_bottleneck_128_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_int
    assert smem(cin, cmid, cout, th, tw, int(proj)) == bn.smem_bytes(cin, cmid, cout, th, tw, proj)


@pytest.mark.parametrize("width,shape", [
    ("fly", (8, 128, 256, 48)),           # a converted fly checkpoint's stem_res1
    ("fly", (3, 19, 37, 48)),             # tiles cut by the image edge
    ("h36m", (8, 192, 192, 64)),          # the 128-wide instance
    ("h36m", (3, 19, 37, 64)),
    ("h36m", (16, 96, 96, 64)),           # more tiles than SMs x ring slots
    ("h36m", (1, 1, 1, 64)),              # the 1x1 image
])
def test_raw_projection_matches_plain(blocks, wide_blocks, width, shape):
    """The raw-input projection (checkpoints converted from torch): the
    projecting instances with x, not relu(bn1(x)), as the projection's
    input; the resident instances' tolerance, and another function than the
    a1 projection."""
    dev = _card()
    block = (blocks if width == "fly" else wide_blocks)["stem_res1"]
    raw = {**{k: v for k, v in block.items() if k != "packed"},
           "proj_raw": torch.ones((), dtype=torch.bool)}
    folded = {k: v.to(dev) for k, v in bn.add_packed(raw).items()}
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(dev)
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    want = bn.bottleneck_plain(x, folded)
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol
    a1 = {k: v for k, v in folded.items() if k != "proj_raw"}
    assert (bn.fused_bottleneck(x, a1) - got).abs().max().item() > 100 * tol


def test_trainable_net_on_card_matches_cpu():
    """One training step of the trainable net (cuDNN, TF32 off) on the card
    against the CPU: losses and gradients within 1e-4 of their scale."""
    from deepfly3d_torch.models import hourglass as hg
    from deepfly3d_torch.models import train as train_mod

    dev = _card()
    spec = hg.HourglassSpec(num_stacks=2, features=16, depth=2, num_classes=5)
    variables = hg.init_params(spec, (32, 64), torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(4, 32, 64, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=(4, 8, 16, 5)).astype(np.float32))
    cells = torch.from_numpy(rng.integers(0, 8, size=(4, 5, 2)))
    peaks = torch.from_numpy(rng.uniform(0.3, 0.9, size=(4, 5)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        net = hg.trainable(variables, spec, device=d)
        loss = train_mod.loss_terms(net(x.to(d), train=True), t.to(d), cells.to(d),
                                    peaks.to(d), 30.0, 1.0)[0]
        loss.backward()
        out[str(d)] = (loss.item(), {n: p.grad.cpu() for n, p in net.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[str(dev)]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    scale = max(g.abs().max().item() for g in g_cpu.values())
    for n in g_cpu:
        assert (g_card[n] - g_cpu[n]).abs().max().item() <= 1e-4 * scale, n


def _general_block(width, proj, raw=False, dtype="float32"):
    params, stats = _smoke().seeded_block(np, *width)
    if not proj:
        params.pop("proj")
    return bn.add_packed(bn.fold_bottleneck(params, stats, raw, dtype))


def _launches():
    f = bn.fused_bottleneck
    return f.launches, f.launches_bf16, f.launches_general, f.launches_general_bf16


def test_block_without_an_instance_raises_on_the_card():
    """Once pinned the fault (a width without an instance raised); now the
    same 96->64->128 projecting block launches the general instance, held
    to the resident instances' tolerance."""
    dev = _card()
    folded = {k: v.to(dev) for k, v in _general_block((96, 64, 128), True).items()}
    assert bn.kernel_for(96, 64, 128, True) == "general"
    x = torch.randn((2, 13, 21, 96), generator=torch.Generator().manual_seed(4)).to(dev)
    before = _launches()
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1], before[2] + 1, before[3])
    want = bn.bottleneck_plain(x, folded)
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cmid,cout,proj,raw,shape", [
    (256, 128, 256, False, False, (2, 64, 128)),   # the converter's 256-wide blocks
    (256, 128, 256, False, False, (3, 4, 8)),
    (128, 128, 256, True, True, (2, 128, 256)),    # its raw projecting stem block
    (16, 8, 16, False, False, (8, 64, 128)),       # the README trainer's widths
    (8, 8, 16, True, False, (8, 128, 256)),
    (8, 8, 16, True, True, (3, 19, 37)),           # the envelope's narrow corner, raw projection
    (96, 64, 128, True, False, (2, 13, 21)),
    (20, 10, 20, False, False, (3, 19, 37)),       # no multiple of 8, tiles cut by the edge
    (13, 7, 11, True, True, (3, 19, 37)),          # odd widths: scalar stores
    (512, 256, 512, False, False, (2, 9, 17)),     # the envelope's edge: two passes of stage 2
    (200, 136, 330, True, False, (2, 11, 23)),     # padded to the wgmma's k and to 64 columns
])
def test_general_bottleneck_matches_plain(cin, cmid, cout, proj, raw, shape, dtype):
    """The general instance against its plain version: float32 within 5e-5 of
    the output's magnitude (and of its 3xTF32 arithmetic model), bf16 within
    2 bf16 ulps, at the envelope's corners and on ragged images; its
    shared-memory and packed-buffer figures are the wrapper's."""
    dev = _card()
    folded = {k: v.to(dev) for k, v in _general_block((cin, cmid, cout), proj, raw,
                                                       dtype).items()}
    x = torch.randn(shape + (cin,), generator=torch.Generator().manual_seed(6))
    x = x.to(dev).to(getattr(torch, dtype))
    before = _launches()
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    bump = (0, 0, 1, 0) if dtype == "float32" else (0, 0, 0, 1)
    assert _launches() == tuple(b + d for b, d in zip(before, bump))
    want = bn.bottleneck_plain(x, folded)
    assert got.dtype == x.dtype and got.shape == shape + (cout,)
    if dtype == "float32":
        tol = 5e-5 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
        assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol
    else:
        ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= 2 * ulp
    lib = _build.library("bottleneck_general")
    lib.df3d_bottleneck_general_smem.argtypes = [ctypes.c_int] * 6
    lib.df3d_bottleneck_general_packed_bytes.argtypes = [ctypes.c_int] * 5
    bf16 = int(dtype == "bfloat16")
    th, tw = bn.choose_tile(*shape, cin, cmid, cout, proj, dtype)
    assert lib.df3d_bottleneck_general_smem(cin, cmid, cout, th, tw, bf16) == \
        bn.smem_bytes(cin, cmid, cout, th, tw, proj, dtype)
    packed = folded["packed"]
    assert lib.df3d_bottleneck_general_packed_bytes(cin, cmid, cout, int(proj), bf16) == \
        packed.numel() * packed.element_size()


def test_block_past_the_envelope_raises_on_the_card():
    """A block wider than the general instance's envelope raises on the card
    (the CPU runs the plain version at any width); nothing falls back."""
    dev = _card()
    params, stats = _smoke().seeded_block(np, 8, 320, 8)
    params.pop("proj")
    folded = {k: v.to(dev) for k, v in bn.add_packed(bn.fold_bottleneck(params, stats)).items()}
    before = _launches()
    with pytest.raises(ValueError, match="envelope"):
        bn.fused_bottleneck(torch.zeros((1, 4, 4, 8), device=dev), folded)
    assert _launches() == before


@pytest.mark.parametrize("shape", [(56, 4, 8, 96), (7, 32, 64, 96), (2, 3, 5, 6)])
def test_upsample_kernel_matches_plain(shape):
    dev = _card()
    n, h, w, c = shape
    g = torch.Generator().manual_seed(1)
    inner = torch.randn(shape, generator=g).to(dev)
    skip = torch.randn((n, 2 * h, 2 * w, c), generator=g).to(dev)
    got = kernels.upsample2x_add(inner, skip)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.upsample2x_add_plain(inner, skip))


# (63, 127) x 19: K x cells is no multiple of 4, the kernel's scalar loads
@pytest.mark.parametrize("hw", [(64, 128), (48, 96), (63, 127)])
def test_decode_kernel_matches_plain_with_ties(hw):
    dev = _card()
    g = torch.Generator().manual_seed(2)
    hm = torch.randn((9,) + hw + (19,), generator=g)
    hm[3, :, :, 5] = -0.0                         # -0.0 ties with a later +0.0: index 0
    hm[3, 20, 7, 5] = 0.0
    hm[4, 30, 11, 6] = hm[4, 31, 2, 6] = float("nan")    # the first NaN wins
    hm[4, 0, 0, 6] = 1e30
    hm[0, :, :, 0] = 3.0                          # all tied: index 0
    hm[1, 10, 5, 3] = hm[1, 40, hw[1] - 28, 3] = 9.0     # first of two peaks
    hm[2, hw[0] - 1, hw[1] - 1, 4] = hm[2, 0, 1, 4] = 9.0
    hm = hm.to(dev)
    pts, conf = kernels.decode_heatmaps(hm)
    torch.cuda.synchronize()
    want_pts, want_conf = kernels.decode_heatmaps_plain(hm)
    assert torch.equal(pts, want_pts)
    assert conf[4, 6].isnan().all() and want_conf[4, 6].isnan().all()
    assert torch.equal(conf.nan_to_num(nan=0.0), want_conf.nan_to_num(nan=0.0))
    assert pts[0, 0].tolist() == [0.0, 0.0] and pts[3, 5].tolist() == [0.0, 0.0]
    assert pts[4, 6].tolist() == [np.float32(30) / np.float32(hw[0]),
                                  np.float32(11) / np.float32(hw[1])]
    assert pts[1, 3].tolist() == [np.float32(10 / hw[0]), np.float32(5 / hw[1])]


def test_wrappers_reject_cpu_mixed_inputs(blocks):
    dev = _card()
    x = torch.zeros((1, 8, 8, 96), device=dev)
    with pytest.raises(ValueError):               # the weight buffer is on the CPU
        bn.fused_bottleneck(x, bn.add_packed(blocks["stem_res2"]))
    with pytest.raises(ValueError):               # no weight buffer at all
        bn.fused_bottleneck(x, {k: v.to(dev) for k, v in blocks["stem_res2"].items()})


# (input shape, Cout): the fly stem, the 256-wide and 128-wide nets' stems
# (at 256x512 and at the h36m profile's 384x384), the 64-feature fly net's,
# odd H and W (the zero padding and the ragged edge masked), the README toy
# net's, and rows cut into bands (3 of 4 m64 blocks at Cout 128, 2 at 48 and
# at 8, the last ragged)
STEM_CARD_SHAPES = [((8, 256, 512, 3), 48), ((8, 256, 512, 3), 64), ((4, 384, 384, 3), 64),
                    ((1, 256, 512, 3), 32), ((3, 250, 502, 3), 48), ((4, 64, 128, 3), 8),
                    ((2, 40, 1500, 3), 128), ((1, 20, 2000, 3), 48), ((1, 24, 4001, 3), 8)]


@pytest.mark.parametrize("shape,cout", STEM_CARD_SHAPES)
def test_stem_kernel_matches_plain(shape, cout):
    """The conv stem kernel (csrc/stem_conv.cu, 3xTF32 wgmma) against its plain
    version (cuDNN, TF32 off) at the bottleneck's tolerance: 5e-5 of the
    output's largest magnitude; one launch, and no scratch beyond its output."""
    dev = _card()
    g = torch.Generator().manual_seed(cout)
    w = torch.randn((cout, 3, 7, 7), generator=g) * 0.15
    packed = kernels.pack_stem(w).to(dev)
    b = (torch.randn((cout,), generator=g) * 0.1).to(dev)
    x = (2.0 * torch.rand(shape, generator=g) - 0.5).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    before = kernels.stem_conv.launches
    got = kernels.stem_conv(x, packed, b)
    torch.cuda.synchronize()
    assert kernels.stem_conv.launches == before + 1
    assert torch.cuda.max_memory_allocated(dev) - held <= got.numel() * 4 + (1 << 20)
    want = kernels.stem_conv_plain(x, packed, b)
    assert got.shape == want.shape
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got >= 0).all()


def test_stem_kernel_refusals_on_the_card():
    dev = _card()
    x = torch.rand((1, 16, 16, 3), device=dev)
    w40 = kernels.pack_stem(torch.zeros((40, 3, 7, 7))).to(dev)
    with pytest.raises(ValueError, match=r"\(8, 32, 48, 64, 128\), not 40"):
        kernels.stem_conv(x, w40, torch.zeros((40,), device=dev))
    w48 = kernels.pack_stem(torch.zeros((48, 3, 7, 7))).to(dev)
    b48 = torch.zeros((48,), device=dev)
    for bad in (x.double(), x.transpose(1, 2)):
        with pytest.raises(ValueError):
            kernels.stem_conv(bad, w48, b48)
    with pytest.raises(ValueError):                 # the weights on the CPU
        kernels.stem_conv(x, w48.cpu(), b48)


def test_stem_kernel_launches_once_per_conv_forward(monkeypatch):
    """A conv-stem forward launches the stem kernel once and calls no
    F.conv2d; two forwards give the same bits."""
    dev = _card()
    variables, spec = load_weights(CHECKPOINT)
    net = FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev).eval()
    x = torch.rand((2, 256, 512, 3), generator=torch.Generator().manual_seed(6)).to(dev)
    with torch.inference_mode():
        want = net(x)
    calls = []
    conv2d = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda *a, **k: (calls.append(a[0].shape), conv2d(*a, **k))[1])
    before = kernels.stem_conv.launches
    with torch.inference_mode():
        got = net(x)
    torch.cuda.synchronize()
    assert kernels.stem_conv.launches == before + 1 and calls == []
    assert torch.equal(got, want)


# (pixels as (N, H, W), classes, remaps): the fly cell's call (224 images of
# 64x128, 28,672 whole m64 blocks), a last block of 39 pixels, one partial
# block, 24 classes (no padded column)
HEADS_CARD_SHAPES = [((224, 64, 128), 19, True), ((224, 64, 128), 19, False),
                     ((3, 7, 11), 19, True), ((3, 7, 11), 19, False), ((1, 1, 5), 24, True),
                     ((56, 64, 128), 24, False)]


def _heads(classes, remap, seed):
    g = torch.Generator().manual_seed(seed)
    t = {"feat_w": torch.randn((96, 96), generator=g) / 96 ** 0.5,
         "feat_b": torch.randn((96,), generator=g) * 0.1,
         "score_w": torch.randn((96, classes), generator=g) / 96 ** 0.5,
         "score_b": torch.randn((classes,), generator=g) * 0.1}
    if remap:
        t.update({"remap_feat_w": torch.randn((96, 96), generator=g) / 96 ** 0.5,
                  "remap_feat_b": torch.randn((96,), generator=g) * 0.1,
                  "remap_score_w": torch.randn((classes, 96), generator=g) / classes ** 0.5,
                  "remap_score_b": torch.randn((96,), generator=g) * 0.1})
    return kernels.pack_heads(t)


@pytest.mark.parametrize("shape,classes,remap", HEADS_CARD_SHAPES)
def test_stack_heads_kernel_matches_plain(shape, classes, remap):
    """The head kernel (csrc/stack_heads.cu, 3xTF32 wgmma) against its plain
    version (cuBLAS, TF32 off) at the bottleneck's tolerance: 5e-5 of each
    output's largest magnitude; one launch, and no scratch beyond y'."""
    dev = _card()
    packed, biases = (t.to(dev) for t in _heads(classes, remap, classes + remap))
    g = torch.Generator().manual_seed(len(shape))
    f_in = torch.randn(shape + (96,), generator=g).to(dev)
    y = torch.randn(shape + (96,), generator=g).to(dev) if remap else None
    out = torch.full(shape + (classes,), float("nan"), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    before = kernels.stack_heads.launches
    got_y = kernels.stack_heads(f_in, y, packed, biases, out)
    torch.cuda.synchronize()
    assert kernels.stack_heads.launches == before + 1
    assert torch.cuda.max_memory_allocated(dev) - held <= (f_in.numel() * 4 if remap else 0) \
        + (1 << 20)
    want = torch.empty_like(out)
    want_y = kernels.stack_heads_plain(f_in, y, packed, biases, want)
    assert (out - want).abs().max().item() <= 5e-5 * max(1.0, want.abs().max().item())
    assert (got_y is None) == (not remap)
    if remap:
        assert (got_y - want_y).abs().max().item() <= 5e-5 * max(1.0, want_y.abs().max().item())


def test_stack_heads_kernel_refusals_on_the_card():
    dev = _card()
    packed, biases = (t.to(dev) for t in _heads(19, True, 0))
    x = torch.rand((1, 4, 4, 96), device=dev)
    out = torch.empty((1, 4, 4, 19), device=dev)
    with pytest.raises(ValueError, match=r"F in \(96,\), not 64"):
        kernels.stack_heads(torch.rand((1, 4, 4, 64), device=dev),
                            torch.rand((1, 4, 4, 64), device=dev), packed, biases, out)
    with pytest.raises(ValueError, match="1 to 24 classes, not 25"):
        kernels.stack_heads(x, x, packed, biases, torch.empty((1, 4, 4, 25), device=dev))
    for bad in (x.double(), x.transpose(1, 2)):
        with pytest.raises(ValueError):
            kernels.stack_heads(bad, x, packed, biases, out)
    with pytest.raises(ValueError):                 # the weights on the CPU
        kernels.stack_heads(x, x, packed.cpu(), biases, out)
    with pytest.raises(ValueError, match="not the heads"):      # no y: the last stack's buffers
        kernels.stack_heads(x, None, packed, biases, out)


def test_stack_heads_launch_once_per_stack_and_match_the_plain_twin():
    """A fly forward launches the head kernel once a stack, and neither a
    library GEMM nor an elementwise pass; its heatmaps match the same net with
    the plain heads within 5e-5 of their size, and the whole plain twin within
    1e-4."""
    dev = _card()
    variables, spec = load_weights(CHECKPOINT)
    net = FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev).eval()
    assert net.heads_fused
    x = torch.rand((7, 256, 512, 3), generator=torch.Generator().manual_seed(9)).to(dev)
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        before = kernels.stack_heads.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = net(x)
            torch.cuda.synchronize()
        assert kernels.stack_heads.launches == before + 2
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        heads = copy.copy(net)
        heads.head_fn = kernels.stack_heads_plain
        want = heads(x)
        plain = copy.copy(net)
        plain.block_fn, plain.merge_fn, plain.stem_fn, plain.head_fn = (
            bn.bottleneck_plain, kernels.upsample2x_add_plain, kernels.stem_conv_plain,
            kernels.stack_heads_plain)
        plain = plain(x)
    assert sum("stack_heads_kernel" in n for n in names) == 2
    # no library GEMM and no elementwise pass is left in the forward
    assert not any("gemm" in n.lower() or "elementwise" in n for n in names), sorted(set(names))
    tol = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 5e-5 * tol
    assert (got - plain).abs().max().item() <= 1e-4 * tol


@pytest.mark.parametrize("shape", [(3, 5, 7, 1), (2, 9, 9, 256), (1, 4, 4, 1000), (300, 2, 2, 3)])
def test_decode_kernel_takes_any_joint_count(shape):
    dev = _card()
    g = torch.Generator().manual_seed(4)
    hm = torch.randn(shape, generator=g).to(dev)
    pts, conf = kernels.decode_heatmaps(hm)
    torch.cuda.synchronize()
    want_pts, want_conf = kernels.decode_heatmaps_plain(hm)
    assert torch.equal(pts, want_pts) and torch.equal(conf, want_conf)


def test_pose_estimator_prefetch_on_card():
    """infer_images with the pinned-memory side-stream prefetch and a padded
    last batch gives what the CPU path gives."""
    dev = _card()
    from deepfly3d_torch.models.inference import PoseEstimator

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        images = z["frames"]
    flip = np.array([False, False, False, False, True, True, True])
    gain = np.array([1.0, 1.0, 0.97, 1.0, 1.0, 1.03, 1.0], np.float32)
    got = PoseEstimator(CHECKPOINT, device=dev).infer_images(images, flip, batch_size=3, gain=gain)
    want = PoseEstimator(CHECKPOINT, device="cpu").infer_images(images, flip, batch_size=3,
                                                                gain=gain)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)


def test_ingest_chunk_loop_on_card():
    """The ingest loop (registration, the shift and the measured gain in the
    preprocess kernel, batch 8 with a padded last batch) gives on the card
    what it gives on the CPU: points equal, conf within 2e-5."""
    dev = _card()
    from deepfly3d_torch.models.inference import PoseEstimator

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        frame = z["frames"][1]
    noise = np.random.RandomState(1).randint(-3, 4, size=(10,) + frame.shape)
    frames = np.clip(np.roll(frame, (4, -6), axis=(0, 1))[None] * 1.06 + noise, 0, 255)
    chunk = [(frames.astype(np.uint8), np.ones(10, int), np.zeros(10, bool))]
    reg_card, reg_cpu = {}, {}
    got = PoseEstimator(CHECKPOINT, device=dev).infer_chunks(chunk, 8, registration=reg_card)
    want = PoseEstimator(CHECKPOINT, device="cpu").infer_chunks(chunk, 8, registration=reg_cpu)
    assert reg_card == reg_cpu and reg_card[1][2] != 1.0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)


@pytest.mark.parametrize("method", ["parabolic", "window"])
def test_soft_argmax_on_card_matches_cpu(method):
    """decode_softargmax on the card (cells from the decode kernel) against a
    CPU copy of the same heatmaps: the same cells and conf, points within
    1e-5; peaks planted on the borders and in the corners, and a flat map."""
    dev = _card()
    from deepfly3d_torch.models import decode as decode_mod

    g = torch.Generator().manual_seed(3)
    hm = torch.rand((8, 64, 128, 19), generator=g) * 0.05
    rr, cc = torch.meshgrid(torch.arange(64.0), torch.arange(128.0), indexing="ij")
    centers = torch.rand((8, 19, 2), generator=g) * torch.tensor([66.0, 130.0]) - 1.0
    centers[0, :4] = torch.tensor([[0.0, 0.0], [63.0, 127.0], [0.0, 64.2], [31.6, 127.0]])
    for n in range(8):
        for k in range(19):
            r, c = centers[n, k].tolist()
            hm[n, :, :, k] += torch.exp(-((rr - r) ** 2 + (cc - c) ** 2) / 4.5)
    hm[1, :, :, 5] = 0.25
    pts, conf = decode_mod.decode_softargmax(hm.to(dev), method=method)
    launches = kernels.decode_heatmaps.launches
    cells = decode_mod.argmax_cells(kernels.decode_heatmaps(hm.to(dev))[0], (64, 128))
    assert kernels.decode_heatmaps.launches == launches + 1
    torch.cuda.synchronize()
    want_pts, want_conf = decode_mod.decode_softargmax(hm, method=method)
    want_cells = decode_mod.argmax_cells(kernels.decode_heatmaps_plain(hm)[0], (64, 128))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(cells, want_cells))
    assert torch.equal(conf.cpu(), want_conf)
    assert (pts.cpu() - want_pts).abs().max().item() <= 1e-5


def test_golden_frame_on_card():
    dev = _card()
    from deepfly3d_torch.pipeline import build_pipeline

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    variables, spec = load_weights(CHECKPOINT)
    pipe = build_pipeline(spec, variables, calib, ref["camera_ordering"], (256, 512),
                          rig=None, device=dev)
    _, p38, conf = pipe(ref["frames"][None])
    np.testing.assert_array_equal(p38.cpu().numpy(), ref["p38"])
    np.testing.assert_allclose(conf.cpu().numpy(), ref["conf"], atol=2e-5, rtol=0)


PREPROCESS_SHAPES = [
    (5, (480, 960), (256, 512)),
    (5, (480, 960), (192, 384)),
    (3, (37, 50), (13, 29)),        # rows of 150 bytes: the instance with runtime taps
    (4, (480, 960), (480, 960)),    # identity: the TPU kernel exactly
    (8, (1000, 1000), (384, 384)),  # the h36m path: the run design's 6-tap instance
]


def _registration(n, dev, seed):
    """Per-image shifts in [-8, 8] and gains in [0.9, 1.1], every other one exactly 1."""
    g = torch.Generator().manual_seed(seed)
    dy, dx = (torch.randint(-8, 9, (n,), generator=g, dtype=torch.int32) for _ in range(2))
    gain = 0.9 + 0.2 * torch.rand(n, generator=g)
    gain[::2] = 1.0
    return dy.to(dev), dx.to(dev), gain.to(dev)


@pytest.mark.parametrize("n,in_hw,out_hw", PREPROCESS_SHAPES)
def test_preprocess_kernel_matches_plain(n, in_hw, out_hw):
    dev = _card()
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (n,) + in_hw + (3,), generator=g, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 2 == 1).to(dev)
    before = kernels.preprocess_resize.launches
    got = kernels.preprocess_resize(x, flip, out_hw)
    torch.cuda.synchronize()
    assert kernels.preprocess_resize.launches == before + 1
    dy, dx, gain = _registration(n, dev, seed=n)
    fused = kernels.preprocess_resize(x, flip, out_hw, shift=(dy, dx), gain=gain)
    rolled = canonicalize.apply_shift_tc(x[None], dy, dx)[0]
    unfused = kernels.preprocess_resize(rolled, flip, out_hw) * gain[:, None, None, None]
    torch.cuda.synchronize()
    assert torch.equal(fused, unfused)
    if out_hw == in_hw:
        assert torch.equal(got, kernels.preprocess_u8_plain(x, flip))
        assert torch.equal(fused, kernels.preprocess_u8_plain(x, flip, (dy, dx), gain))
    else:
        want = image_ops.preprocess_frames_plain(x, flip, out_hw)
        assert (got - want).abs().max().item() <= 2e-6
        want = image_ops.preprocess_frames_plain(x, flip, out_hw, shift=(dy, dx), gain=gain)
        tol = 2e-6 * max(1.0, gain.max().item())
        assert (fused - want).abs().max().item() <= tol


@pytest.mark.parametrize("n,in_hw,out_hw", PREPROCESS_SHAPES)
def test_preprocess_kernel_layout_and_instance(n, in_hw, out_hw):
    """The wrapper's shared-memory figures are the kernel's, in both designs;
    path shapes (the h36m path's 1000 -> 384 too) and identity mode run the
    run design's instance of their taps, the one the wrapper's mirror names;
    other shapes and unaligned frames the one with runtime taps, with the
    same result."""
    dev = _card()
    lib = _build.library("preprocess")
    rows, stage_rows, smem = kernels.preprocess_plan(*in_hw, 3, *out_hw,
                                                     kernels.PREPROCESS_STAGE_ROWS)
    kh = image_ops.resize_taps(in_hw[0], out_hw[0])[1].shape[1]
    kw = image_ops.resize_taps(in_hw[1], out_hw[1])[1].shape[1]
    lib.df3d_preprocess_smem.argtypes = [ctypes.c_int] * 8
    lib.df3d_preprocess_smem.restype = ctypes.c_size_t
    assert lib.df3d_preprocess_smem(in_hw[1], 3, *out_hw, kh, kw, rows, stage_rows) == smem
    run = kernels.preprocess_run_plan(n, *in_hw, 3, *out_hw)
    lib.df3d_preprocess_run_smem.argtypes = [ctypes.c_int] * 6
    lib.df3d_preprocess_run_smem.restype = ctypes.c_size_t
    assert lib.df3d_preprocess_run_smem(in_hw[1], 3, out_hw[1], kw, run.ring_rows,
                                        run.hslots) == run.smem
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (n,) + in_hw + (3,), generator=g, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 2 == 0).to(dev)
    out = kernels.preprocess_resize(x, flip, out_hw)
    instance = lib.df3d_preprocess_instance
    instance.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    steps = kernels.preprocess_steps(in_hw[0], out_hw[0]) is not None
    got = instance(3, in_hw[1], out_hw[1], kh, kw, int(steps), x.data_ptr(), out.data_ptr())
    assert got == kernels.preprocess_instance(3, in_hw[1], out_hw[1], kh, kw, steps,
                                              x.data_ptr(), out.data_ptr())
    assert got == (0 if in_hw == (37, 50) else 256 + kh * 16 + kw)
    shifted = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(x.shape)
    shifted.copy_(x)                                   # one byte off 16-byte alignment
    assert instance(3, in_hw[1], out_hw[1], kh, kw, int(steps), shifted.data_ptr(),
                    out.data_ptr()) == 0
    assert torch.equal(kernels.preprocess_resize(shifted, flip, out_hw), out)


@pytest.mark.parametrize("n,in_hw,out_hw", [(8, (1000, 1000), (384, 384)),
                                            (7, (480, 960), (256, 512))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_run_ring_phases_wrap(n, in_hw, out_hw, dtype, monkeypatch):
    """A ring that holds only the input rows of one output row (6 slots at
    1000 -> 384, 4 at 480 -> 256): every run is many times longer, so the
    ring's phases wrap again and again; the same bits as the planned ring,
    and the plain version's tolerance (float32 2e-6, bf16 one ulp)."""
    dev = _card()
    g = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (n,) + in_hw + (3,), generator=g, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 3 == 1).to(dev)
    dy, dx, gain = _registration(n, dev, seed=n + 1)
    call = lambda: kernels.preprocess_resize(x, flip, out_hw, shift=(dy, dx), gain=gain,
                                             dtype=dtype)
    planned = call()
    kh = image_ops.resize_taps(in_hw[0], out_hw[0])[1].shape[1]
    monkeypatch.setattr(kernels, "PREPROCESS_RING_ROWS", kh)
    run = kernels.preprocess_run_plan(n, *in_hw, 3, *out_hw, kh)
    starts = image_ops.resize_taps(in_hw[0], out_hw[0])[0]
    fewest = min(sum(int(starts[ob - 1]) + kh - int(starts[oa]) for _, oa, ob in runs)
                 for runs in kernels.preprocess_runs(n, out_hw[0], run.grid))
    assert run.ring_rows == kh and fewest > 2 * kh     # every block's rows wrap the ring
    shallow = call()
    torch.cuda.synchronize()
    assert torch.equal(shallow, planned)
    want = image_ops.preprocess_frames_plain(x, flip, out_hw, dtype, shift=(dy, dx),
                                             gain=gain).float()
    if dtype == "float32":
        assert (shallow - want).abs().max().item() <= 2e-6 * max(1.0, gain.max().item())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((shallow.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_frames_eight_bytes_off_alignment(dtype):
    """A 1000x1000 batch whose frames start 8 bytes off 16-byte alignment (its
    3000-byte rows then start 8 and 0 bytes off in turn) still runs the run
    design, copying each row's 16-byte cover: the same bits as the same
    frames aligned."""
    dev = _card()
    g = torch.Generator().manual_seed(13)
    n = 8
    base = torch.randint(0, 256, (n * 1000 * 1000 * 3 + 8,), generator=g, dtype=torch.uint8)
    frames = base.to(dev)[8:].view(n, 1000, 1000, 3)
    assert frames.data_ptr() % 16 == 8
    aligned = frames.clone()
    flip = (torch.arange(n) % 2 == 1).to(dev)
    dy, dx, gain = _registration(n, dev, seed=17)
    reg = dict(shift=(dy, dx), gain=gain, dtype=dtype)
    got = kernels.preprocess_resize(frames, flip, (384, 384), **reg)
    assert kernels.preprocess_instance_for(frames, got) == "run 6x6"
    assert torch.equal(got, kernels.preprocess_resize(aligned, flip, (384, 384), **reg))


def test_preprocess_rejects_registration_on_the_cpu():
    dev = _card()
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=dev)
    flip = torch.zeros(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        kernels.preprocess_resize(x, flip, (8, 8), gain=torch.ones(2))
    with pytest.raises(ValueError):
        kernels.preprocess_resize(x, flip, (8, 8), shift=(torch.zeros(2, dtype=torch.int32),
                                                          torch.zeros(2, dtype=torch.int32)))


def _golden_frames(T):
    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        ref = {k: z[k] for k in z.files}
    rng = np.random.default_rng(1)
    noise = rng.integers(-3, 4, size=(T,) + ref["frames"].shape, dtype=np.int16)
    frames = np.clip(ref["frames"][None].astype(np.int16) + noise, 0, 255).astype(np.uint8)
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    return frames, ref["camera_ordering"], calib


# per-camera rolls and one gain planted on the golden frames
DRIFT_DY, DRIFT_DX, DRIFT_GAIN = [3, -5, 0, 8, -2, 6, -8], [-4, 7, 2, 0, -8, 5, 1], 1.06


@pytest.mark.parametrize("path", ["p16", "cascade", "conv_drifted"])
def test_pipeline_matches_plain_twin(path):
    dev = _card()
    from deepfly3d_torch.models.cascade import build_cascade_pipeline
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin

    frames, order, calib = _golden_frames(T=2)
    if path == "p16":
        variables, spec = load_weights(os.path.join(REPO, "weights", "hourglass_fly_p16_tpu.npz"))
        pipe = build_pipeline(spec, variables, calib, order, device=dev)
    elif path == "cascade":
        pipe = build_cascade_pipeline(
            *load_weights(os.path.join(REPO, "weights", "hourglass_fly_fast_nearparity.npz")),
            *load_weights(CHECKPOINT), calib, order, device=dev)
    else:
        variables, spec = load_weights(CHECKPOINT)
        pipe = build_pipeline(spec, variables, calib, order, device=dev)
        clean = canonicalize.estimate_tc(torch.from_numpy(frames).to(dev), pipe.rig)
        frames = np.stack([np.roll(frames[:, c], (DRIFT_DY[c], DRIFT_DX[c]), axis=(1, 2))
                           for c in range(7)], axis=1)
        frames = np.clip(np.rint(frames * np.float32(DRIFT_GAIN)), 0, 255).astype(np.uint8)
        dy, dx, gain = canonicalize.estimate_tc(torch.from_numpy(frames).to(dev), pipe.rig)
        assert (dy - clean[0]).tolist() == DRIFT_DY and (dx - clean[1]).tolist() == DRIFT_DX
        assert bool((gain != 1.0).all())
    before = kernels.preprocess_resize.launches
    p3d, p38, conf = pipe(frames)
    torch.cuda.synchronize()
    assert kernels.preprocess_resize.launches == before + (2 if path == "cascade" else 1)
    twin = plain_twin(pipe)
    q3d, q38, qconf = twin(frames)
    assert kernels.preprocess_resize.launches == before + (2 if path == "cascade" else 1)
    assert torch.equal(p38, q38)
    assert (conf - qconf).abs().max().item() <= 1e-4
    assert ((p3d - q3d).abs().max() / q3d.abs().max()).item() <= 1e-5
    if path == "cascade":
        assert torch.equal(pipe.last_repaired, twin.last_repaired)


def _h36m_pipeline(dev, tmp_path, T=2):
    """The h36m profile at its published widths (4 stacks, 128 features,
    384x384, 17 joints) on seeded weights, 4 distorted 1000x1000 cameras."""
    from deepfly3d_torch.pipeline import build_pipeline
    from deepfly3d_torch.utils import synthetic

    path = str(tmp_path / "h36m.npz")
    synthetic.random_checkpoint(path, 3, 4, 128, 4, 17, (384, 384))
    rig = synthetic.human_rig()
    frames, _, _ = synthetic.human_frames(5, T, rig)
    calib = geometry.calib_to_arrays(rig, 4, dtype=np.float32)
    variables, spec = load_weights(path)
    pipe = build_pipeline(spec, variables, calib, [0, 1, 2, 3], rig=None, device=dev,
                          profile="h36m")
    return pipe, np.ascontiguousarray(frames.transpose(1, 0, 2, 3, 4))


def test_h36m_pipeline_matches_plain_twin(tmp_path):
    """Every block of the 128-wide net in ``bottleneck_128.cu``, the stem in
    ``stem_conv_kernel<64>``: points2d equal to the plain twin's, conf within
    the bottleneck's 5e-5 of the largest, points3d within 1e-5 relative."""
    dev = _card()
    from deepfly3d_torch.pipeline import plain_twin

    pipe, frames = _h36m_pipeline(dev, tmp_path)
    p3d, p2d, conf = pipe(frames)
    q3d, q2d, qconf = plain_twin(pipe)(frames)
    assert p3d.shape == (2, 17, 3) and p2d.shape == (4, 2, 17, 2) and conf.shape == (4, 2, 17, 1)
    assert torch.equal(p2d, q2d)
    assert (conf - qconf).abs().max().item() <= 5e-5 * qconf.abs().max().item()
    assert ((p3d - q3d).abs().max() / q3d.abs().max()).item() <= 1e-5


def test_h36m_call_launches_by_kernel(tmp_path):
    """One h36m call: 59 blocks in the 128-wide instances, the stem kernel,
    16 upsample-adds (4 stacks x depth 4), one preprocess and one decode; no
    fly, general or head kernel."""
    dev = _card()
    pipe, frames = _h36m_pipeline(dev, tmp_path)
    f = bn.fused_bottleneck
    counters = [(f, "launches_128"), (f, "launches"), (f, "launches_general"),
                (kernels.stem_conv, "launches"), (kernels.upsample2x_add, "launches"),
                (kernels.preprocess_resize, "launches"), (kernels.decode_heatmaps, "launches"),
                (kernels.stack_heads, "launches")]
    before = [getattr(obj, name) for obj, name in counters]
    pipe(frames)
    torch.cuda.synchronize()
    assert [getattr(obj, name) - b for (obj, name), b in zip(counters, before)] == \
        [59, 0, 0, 1, 16, 1, 1, 0]


def test_kernel_wrappers_launch_under_their_input_device(blocks, monkeypatch):
    """Each wrapper enters ``torch.cuda.device(<its input's device>)`` around
    its launch: the libraries take the device from ``cudaGetDevice``."""
    dev = _card()
    real = torch.cuda.device
    entered = []

    class Spy:                  # PyTorch itself enters torch.cuda.device(None) too
        def __init__(self, device):
            self.device, self.inner = device, real(device)

        def __enter__(self):
            if self.device is not None:
                entered.append(torch.device(self.device))
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(torch.cuda, "device", Spy)
    g = torch.Generator().manual_seed(5)
    folded = {k: v.to(dev) for k, v in bn.add_packed(blocks["stem_res2"]).items()}
    calls = {
        bn.fused_bottleneck: lambda: bn.fused_bottleneck(
            torch.randn((2, 8, 16, 96), generator=g).to(dev), folded),
        kernels.upsample2x_add: lambda: kernels.upsample2x_add(
            torch.randn((2, 4, 8, 96), generator=g).to(dev),
            torch.randn((2, 8, 16, 96), generator=g).to(dev)),
        kernels.decode_heatmaps: lambda: kernels.decode_heatmaps(
            torch.randn((2, 16, 32, 19), generator=g).to(dev)),
        kernels.preprocess_resize: lambda: kernels.preprocess_resize(
            torch.randint(0, 256, (2, 48, 96, 3), generator=g, dtype=torch.uint8).to(dev),
            torch.tensor([False, True], device=dev), (16, 32)),
        kernels.stem_conv: lambda: kernels.stem_conv(
            torch.rand((2, 32, 64, 3), generator=g).to(dev),
            kernels.pack_stem(torch.randn((48, 3, 7, 7), generator=g)).to(dev),
            torch.randn((48,), generator=g).to(dev)),
        kernels.stack_heads: lambda: kernels.stack_heads(
            torch.randn((2, 8, 16, 96), generator=g).to(dev),
            torch.randn((2, 8, 16, 96), generator=g).to(dev),
            *(t.to(dev) for t in _heads(19, True, 5)),
            torch.empty((2, 8, 16, 19), device=dev)),
    }
    for wrapper, call in calls.items():
        entered.clear()
        before = wrapper.launches
        call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert dev in entered and all(d == dev for d in entered), (wrapper.__name__, entered)


def test_batched_lm_on_card_matches_cpu():
    """The committed 8-member batched solve (parallel_lm_b8.npz) on the card
    in float64 against the CPU: the same iteration counts, cameras within
    1e-10 of the largest camera parameter, costs within 1e-9 relative."""
    dev = _card()
    from deepfly3d_torch.parallel import pipeline

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "parallel_lm_b8.npz")) as z:
        ref = {k: z[k] for k in z.files}
    B = ref["cams0"].shape[0]
    args = [ref["cams0"], ref["pts0"]] + [np.broadcast_to(ref[k], (B,) + ref[k].shape)
                                          for k in ("K", "dist", "obs", "mask")]
    iters = int(ref["max_iters"])
    card = pipeline.make_batched_calibration((960, 480), max_iters=iters)(*args)
    cpu = pipeline.make_batched_calibration((960, 480), max_iters=iters, device="cpu")(*args)
    assert card[0].device == dev and card[0].dtype == torch.float64
    assert torch.equal(card[4].cpu(), cpu[4])
    scale = cpu[0].abs().max().item()
    assert (card[0].cpu() - cpu[0]).abs().max().item() <= 1e-10 * scale
    np.testing.assert_allclose(card[3].cpu().numpy(), cpu[3].numpy(), rtol=1e-9)


def test_two_entry_mesh_infer_matches_one_forward():
    """make_sharded_infer over two entries of the one card (golden frame 0 of
    7 cameras, padded to 8): one forward per entry (31 bottleneck launches
    each), points within 1e-6 and conf within 1e-5 of one forward over all 8."""
    dev = _card()
    from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
    from deepfly3d_torch.models.inference import infer_batch
    from deepfly3d_torch.parallel import mesh, pipeline

    with np.load(os.path.join(REPO, "deepfly3d_torch", "data", "golden_t0.npz")) as z:
        images = z["frames"]
    images = np.concatenate([images, images[:1]])
    flip = np.array([False] * 4 + [True] * 3 + [False])
    variables, spec = load_weights(CHECKPOINT)
    infer = pipeline.make_sharded_infer(spec, mesh.data_mesh(devices=[dev, dev]), (256, 512))
    before = bn.fused_bottleneck.launches
    pts, conf = infer(variables, images, flip)
    assert bn.fused_bottleneck.launches == before + 2 * 31
    net = FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev).eval()
    want = infer_batch(net, torch.from_numpy(images).to(dev), torch.from_numpy(flip).to(dev),
                       (256, 512))
    np.testing.assert_allclose(pts.numpy(), want[0].cpu().numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(conf.numpy(), want[1].cpu().numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------- bfloat16


def _smoke():
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _bf16_block(width, proj, raw=False, positive_b1=False):
    params, stats = _smoke().seeded_block(np, *width)
    if positive_b1:              # a2's zero padding differs from relu(b1) at the edges
        params["conv1"]["bias"] = np.abs(params["conv1"]["bias"]) + 0.3
    if not proj:
        params.pop("proj")
    return bn.add_packed(bn.fold_bottleneck(params, stats, raw, "bfloat16"))


# (N, H, W, positive b1) of the bf16 instance's card test: tiles that the image
# edge cuts (19x37); one tile that the image cuts on all four sides (5x7); the
# launch-floor shapes (56x2x4, 7x4x8); more tiles than 132 SMs x 4 ring slots,
# so that every slot's phase wraps (56x32x64); a folded b1 with positive
# entries, where a2's zero padding is not relu(b1)
BF16_CARD_SHAPES = [(3, 19, 37, False), (2, 5, 7, True), (56, 2, 4, False), (7, 4, 8, True),
                    (56, 32, 64, True)]


@pytest.mark.parametrize("cin,cmid,cout,proj,raw", [
    (*b, False) for b in bn.INSTANCES] + [(*b, True) for b in bn.INSTANCES if b[3]])
def test_bf16_bottleneck_kernel_matches_plain(cin, cmid, cout, proj, raw):
    """The bf16 instance within 2 bf16 ulps of the output's largest magnitude
    (its k16 sums against float32 sums in another order; chip_smoke.py's
    tolerance) at every shape of BF16_CARD_SHAPES, one launch each; the
    wrapper's shared-memory figure is the kernel's own."""
    dev = _card()
    smem = _build.library("bottleneck_bf16").df3d_bottleneck_bf16_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    for n, h, w, positive_b1 in BF16_CARD_SHAPES:
        folded = {k: v.to(dev) for k, v in
                  _bf16_block((cin, cmid, cout), proj, raw, positive_b1).items()}
        x = torch.randn((n, h, w, cin), generator=torch.Generator().manual_seed(2))
        x = x.to(dev).to(torch.bfloat16)
        before = (bn.fused_bottleneck.launches, bn.fused_bottleneck.launches_bf16)
        got = bn.fused_bottleneck(x, folded)
        torch.cuda.synchronize()
        assert (bn.fused_bottleneck.launches, bn.fused_bottleneck.launches_bf16) == \
            (before[0], before[1] + 1)
        assert got.dtype == torch.bfloat16
        want = bn.bottleneck_plain(x, folded).float()
        ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        assert (got.float() - want).abs().max().item() <= 2 * ulp, (n, h, w, positive_b1)
        th, tw = bn.choose_tile(n, h, w, cin, cmid, cout, proj, "bfloat16")
        assert smem(cin, cmid, cout, th, tw, int(proj)) == \
            bn.smem_bytes(cin, cmid, cout, th, tw, proj, "bfloat16")


def test_bf16_block_refusals_on_the_card():
    """A bf16 tensor of a width without a bf16 instance launches the general
    bf16 instance (it raised until the general instance came), within 2 bf16
    ulps of its plain version; a block folded at float32 raises; nothing falls
    back to the plain version or float32."""
    dev = _card()
    params, stats = _smoke().seeded_block(np, 256, 128, 256)
    params.pop("proj")
    wide = {k: v.to(dev) for k, v in bn.add_packed(
        bn.fold_bottleneck(params, stats, dtype="bfloat16")).items()}
    x = torch.randn((1, 4, 4, 256), generator=torch.Generator().manual_seed(8))
    x = x.to(dev).to(torch.bfloat16)
    before = _launches()
    got = bn.fused_bottleneck(x, wide)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1], before[2], before[3] + 1)
    want = bn.bottleneck_plain(x, wide).float()
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got.float() - want).abs().max().item() <= 2 * ulp
    f32 = {k: v.to(dev) for k, v in bn.add_packed(
        bn.fold_bottleneck(*_smoke().seeded_block(np, 48, 48, 96))).items()}
    with pytest.raises(ValueError, match="dtype it was folded for"):
        bn.fused_bottleneck(torch.zeros((1, 4, 4, 48), device=dev, dtype=torch.bfloat16), f32)


@pytest.mark.parametrize("shape", [(56, 4, 8, 96), (7, 32, 64, 96), (2, 3, 5, 6)])
def test_bf16_upsample_kernel_matches_plain(shape):
    dev = _card()
    n, h, w, c = shape
    g = torch.Generator().manual_seed(1)
    inner = torch.randn(shape, generator=g).to(dev).to(torch.bfloat16)
    skip = torch.randn((n, 2 * h, 2 * w, c), generator=g).to(dev).to(torch.bfloat16)
    before = kernels.upsample2x_add.launches_bf16
    got = kernels.upsample2x_add(inner, skip)
    torch.cuda.synchronize()
    assert kernels.upsample2x_add.launches_bf16 == before + 1
    assert torch.equal(got, kernels.upsample2x_add_plain(inner, skip))


@pytest.mark.parametrize("n,in_hw,out_hw", [(7, (480, 960), (256, 512)),
                                            (7, (480, 960), (192, 384)),
                                            (2, (1000, 1000), (384, 384))])
def test_bf16_preprocess_kernel_matches_plain(n, in_hw, out_hw):
    """The bf16-output instance within one ulp of each element of its plain
    version (its float32 sums in another order), with the registration."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (n,) + in_hw + (3,), generator=g, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 2 == 1).to(dev)
    shift = tuple(torch.randint(-8, 9, (n,), generator=g, dtype=torch.int32).to(dev)
                  for _ in range(2))
    gain = (0.9 + 0.2 * torch.rand(n, generator=g)).to(dev)
    before = kernels.preprocess_resize.launches_bf16
    got = kernels.preprocess_resize(x, flip, out_hw, shift=shift, gain=gain, dtype="bfloat16")
    torch.cuda.synchronize()
    assert kernels.preprocess_resize.launches_bf16 == before + 1 and got.dtype == torch.bfloat16
    want = image_ops.preprocess_frames_plain(x, flip, out_hw, "bfloat16", shift=shift,
                                             gain=gain).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())
