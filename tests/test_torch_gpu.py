"""The port's CUDA kernels vs their plain versions, on a card.

Marked ``gpu``: on a machine without a CUDA device every test skips (the
decision is made inside each test, so every pytest worker collects the
same tests).  Run on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Tolerances: the bottleneck computes its ~500-term sums as error-compensated
TF32 products on the tensor cores, in another order than cuDNN/cuBLAS, so
its error against the plain version and against its own arithmetic model
(``bottleneck_tf32_model``) is held to 5e-5 of the output's largest
magnitude; the upsample-add and the decode are exact (NaN and signed zeros
included).  The preprocess sums
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

import ctypes
import os
import pickle

import numpy as np
import pytest
import torch

from deepfly3d_torch.models.fused_inference import fold_hourglass
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


@pytest.mark.parametrize("name,shape", [
    ("stem_res1", (2, 128, 256, 48)),
    ("stem_res2", (3, 64, 128, 96)),
    ("hg0/down_d1_0", (5, 4, 8, 96)),
    ("hg1/skip_d2_0", (2, 13, 21, 96)),   # tiles cut by the image edge
    ("stem_res1", (7, 128, 256, 48)),     # the projection block at the teacher's batch
    ("stem_res1", (1, 19, 37, 48)),       # projection, tiles cut by the image edge
    ("hg0/innermost_0", (56, 3, 6, 96)),  # the patchify student's odd innermost level
    ("hg0/innermost_0", (56, 2, 4, 96)),  # p16's innermost level
    ("hg0/up_d3_0", (7, 16, 32, 96)),     # small batch: thin tiles
    ("feat_res0", (1, 1, 1, 96)),
])
def test_bottleneck_kernel_matches_plain(blocks, name, shape):
    dev = _card()
    folded = {k: v.to(dev) for k, v in bn.add_packed(blocks[name]).items()}
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
    # the wrapper's shared-memory budget is the kernel's own figure
    n, h, w, cin = shape
    args = (cin, folded["w1"].shape[1], folded["w3"].shape[1],
            *bn.choose_tile(n, h, w, cin, folded["w1"].shape[1], folded["w3"].shape[1],
                            "wp" in folded), int("wp" in folded))
    smem = _build.library("bottleneck").df3d_bottleneck_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    assert smem(*args) == bn.smem_bytes(*args[:5], "wp" in folded)


@pytest.fixture(scope="module")
def wide_blocks(tmp_path_factory):
    """The 128-wide h36m network's folded blocks, weights from a seed."""
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    path = str(tmp_path_factory.mktemp("h36m") / "h36m.npz")
    random_checkpoint(path, 0, num_stacks=1, features=128, depth=1, num_classes=17,
                      input_shape=(64, 64))
    return fold_hourglass(*load_weights(path))["blocks"]


@pytest.mark.parametrize("name,shape", [
    ("stem_res1", (8, 192, 192, 64)),     # the projecting stem block of the h36m path
    ("stem_res1", (3, 19, 37, 64)),       # tiles cut by the image edge
    ("stem_res2", (8, 96, 96, 128)),
    ("stem_res2", (8, 12, 12, 128)),
    ("hg0/innermost_0", (8, 6, 6, 128)),
    ("hg0/innermost_0", (5, 13, 21, 128)),
    ("feat_res0", (1, 1, 1, 128)),        # one tile: no next tile's tap 0 to fetch
])
def test_streamed_bottleneck_matches_plain(wide_blocks, name, shape):
    """The 128-wide instances stream w2 through shared memory one tap at a
    time; held to the resident instances' tolerance, and their shared-memory
    figure is the wrapper's."""
    dev = _card()
    folded = {k: v.to(dev) for k, v in bn.add_packed(wide_blocks[name]).items()}
    cin, cmid, cout, proj = shape[3], folded["w1"].shape[1], folded["w3"].shape[1], \
        "wp" in folded
    assert bn.streams_w2(cin, cmid, cout, proj)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=g).to(dev)
    before = bn.fused_bottleneck.launches
    got = bn.fused_bottleneck(x, folded)
    torch.cuda.synchronize()
    assert bn.fused_bottleneck.launches == before + 1
    want = bn.bottleneck_plain(x, folded)
    tol = 5e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (got - bn.bottleneck_tf32_model(x, folded)).abs().max().item() <= tol
    n, h, w, _ = shape
    args = (cin, cmid, cout, *bn.choose_tile(n, h, w, cin, cmid, cout, proj), int(proj))
    smem = _build.library("bottleneck").df3d_bottleneck_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    assert smem(*args) == bn.smem_bytes(*args[:5], proj)


def test_block_without_an_instance_raises_on_the_card(wide_blocks):
    dev = _card()
    folded = {k: v.to(dev) for k, v in bn.add_packed(wide_blocks["stem_res2"]).items()}
    narrow = {k: (v[:, :96] if k in ("s1", "t1") else v[:96] if k == "w1" else v)
              for k, v in folded.items()}
    with pytest.raises(ValueError, match="Cin=96, Cmid=64, Cout=128"):
        bn.fused_bottleneck(torch.zeros((1, 4, 4, 96), device=dev), {**narrow, "wp": torch.zeros(
            (96, 128), device=dev), "bp": torch.zeros((1, 128), device=dev)})


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
    """The wrapper's shared-memory figure is the kernel's; path shapes run an
    instance with compile-time taps, other shapes and unaligned frames the
    one with runtime taps, with the same result."""
    dev = _card()
    lib = _build.library("preprocess")
    rows, stage_rows, smem = kernels.preprocess_plan(*in_hw, 3, *out_hw,
                                                     kernels.PREPROCESS_STAGE_ROWS)
    kh = image_ops.resize_taps(in_hw[0], out_hw[0])[1].shape[1]
    kw = image_ops.resize_taps(in_hw[1], out_hw[1])[1].shape[1]
    lib.df3d_preprocess_smem.argtypes = [ctypes.c_int] * 8
    lib.df3d_preprocess_smem.restype = ctypes.c_size_t
    assert lib.df3d_preprocess_smem(in_hw[1], 3, *out_hw, kh, kw, rows, stage_rows) == smem
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (n,) + in_hw + (3,), generator=g, dtype=torch.uint8).to(dev)
    flip = (torch.arange(n) % 2 == 0).to(dev)
    out = kernels.preprocess_resize(x, flip, out_hw)
    instance = lib.df3d_preprocess_instance
    instance.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    want = 0 if in_hw == (37, 50) else kh * 16 + kw
    assert instance(3, in_hw[1], out_hw[1], kh, kw, x.data_ptr(), out.data_ptr()) == want
    shifted = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(x.shape)
    shifted.copy_(x)                                   # one byte off 16-byte alignment
    assert instance(3, in_hw[1], out_hw[1], kh, kw, shifted.data_ptr(), out.data_ptr()) == 0
    assert torch.equal(kernels.preprocess_resize(shifted, flip, out_hw), out)


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
