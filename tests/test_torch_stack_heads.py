"""The head kernel's contract on the CPU (``ops/kernels.stack_heads``).

The kernel (``csrc/stack_heads.cu``) runs only on a card; here its plain
version is held bit for bit to the head chain it replaces, its packed weights
to the folded ones, and its operand order (each lane's A fragments: f_in read
16 bytes a pixel for two k steps, then the accumulators of one product as the
A of the next), its zero padding of the classes, its tail of a last m64 block
and its 3xTF32 arithmetic, written out in plain PyTorch, to the plain version.
The forward takes the kernel's path only for a float32 96-wide net with a 1x1
score head.  The card tests are in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import os
import re

import pytest
import torch

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import kernels
from deepfly3d_torch.ops.bottleneck import split_tf32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights")
CHECKPOINT = os.path.join(WEIGHTS, "hourglass_fly.npz")
SOURCE = os.path.join(REPO, "deepfly3d_torch", "ops", "csrc", "stack_heads.cu")
# floats of csrc/stack_heads.cu's packed buffer, with the remaps and without
# (packed_layout: Wf 96x96, [Ws | Wrf] 96x120 or Ws 96x24, Wrs 24x96, as hi and lo)
PACKED_REMAP, PACKED_LAST = 2 * (96 * 96 + 96 * 24 + 96 * 96 + 24 * 96), 2 * (96 * 96 + 96 * 24)


@pytest.fixture(scope="module")
def fly():
    variables, spec = load_weights(CHECKPOINT)
    return FoldedHourglass(fold_hourglass(variables, spec), spec)


def _stack(features: int, classes: int, remap: bool, seed: int):
    g = torch.Generator().manual_seed(seed)
    f, k = features, classes
    t = {"feat_w": torch.randn((f, f), generator=g) / f ** 0.5,
         "feat_b": torch.randn((f,), generator=g) * 0.1,
         "score_w": torch.randn((f, k), generator=g) / f ** 0.5,
         "score_b": torch.randn((k,), generator=g) * 0.1}
    if remap:
        t.update({"remap_feat_w": torch.randn((f, f), generator=g) / f ** 0.5,
                  "remap_feat_b": torch.randn((f,), generator=g) * 0.1,
                  "remap_score_w": torch.randn((k, f), generator=g) / k ** 0.5,
                  "remap_score_b": torch.randn((f,), generator=g) * 0.1})
    return t


def _todays_chain(f_in, y, t):
    """The head chain as the forward ran it before the kernel: cuBLAS-style
    1x1 products, their broadcast bias adds, the ReLU and the two adds."""
    f = torch.relu(f_in @ t["feat_w"] + t["feat_b"])
    raw = f @ t["score_w"] + t["score_b"]
    if y is None:
        return raw, None
    rf = f @ t["remap_feat_w"] + t["remap_feat_b"]
    rs = raw @ t["remap_score_w"] + t["remap_score_b"]
    return raw, (y + rf) + rs


def _inputs(shape, features, remap, seed):
    g = torch.Generator().manual_seed(seed)
    f_in = torch.randn(shape + (features,), generator=g)
    return f_in, torch.randn(shape + (features,), generator=g) if remap else None


def _run(fn, f_in, y, packed, biases, classes):
    out = torch.full(f_in.shape[:3] + (classes,), float("nan"))
    return out, fn(f_in, y, packed, biases, out)


@pytest.mark.parametrize("stack", [0, 1])
@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 1, 1), (3, 5, 7)])
def test_plain_is_todays_chain_at_the_fly_weights(fly, stack, shape):
    """Stack 0 (the remaps) and stack 1 (the last) of the fly checkpoint: the
    plain version, and the wrapper on CPU tensors, give today's bits."""
    t = fly.stacks[stack]
    remap = stack == 0
    f_in, y = _inputs(shape, 96, remap, stack)
    want_raw, want_y = _todays_chain(f_in, y, {k: getattr(t, k) for k in t.as_dict()})
    for fn in (kernels.stack_heads_plain, kernels.stack_heads):
        out, got_y = _run(fn, f_in, y, t.head_packed, t.head_biases, 19)
        assert torch.equal(out, want_raw)
        assert (got_y is None) == (not remap)
        if remap:
            assert torch.equal(got_y, want_y)


@pytest.mark.parametrize("features,classes,remap", [(96, 19, True), (96, 19, False),
                                                    (96, 24, True), (96, 1, False),
                                                    (16, 5, True), (128, 17, False)])
def test_plain_is_todays_chain_at_seeded_weights(features, classes, remap):
    t = _stack(features, classes, remap, features + classes)
    f_in, y = _inputs((2, 6, 10), features, remap, 5)
    packed, biases = kernels.pack_heads(t)
    want_raw, want_y = _todays_chain(f_in, y, t)
    out, got_y = _run(kernels.stack_heads_plain, f_in, y, packed, biases, classes)
    assert torch.equal(out, want_raw)
    if remap:
        assert torch.equal(got_y, want_y)


@pytest.mark.parametrize("features,classes,remap", [(96, 19, True), (96, 19, False),
                                                    (96, 24, True), (96, 3, True),
                                                    (32, 7, False)])
def test_packed_heads_round_trip_with_zero_padding(features, classes, remap):
    t = _stack(features, classes, remap, 11 * classes)
    packed, biases = kernels.pack_heads(t)
    assert packed.dtype == biases.dtype == torch.float32
    if features == 96:
        assert packed.numel() == (PACKED_REMAP if remap else PACKED_LAST)
    got = kernels.unpack_heads(packed, biases, features, classes, remap)
    assert set(got) == set(t)
    for k, v in t.items():
        assert got[k].is_contiguous() and torch.equal(got[k], v), k
    # every part's hi half is a TF32 number; the padded classes are zero
    f, p = features, kernels.HEAD_CLASSES
    parts = [(f, f, "quad"), (f, p + (f if remap else 0), "pair")] + ([(p, f, "pair")]
                                                                    if remap else [])
    at = 0
    for i, (rows, cols, order) in enumerate(parts):
        flat = packed[at:at + 2 * rows * cols]
        assert not (flat.reshape(rows // 8, 2, -1)[:, 0].contiguous().view(torch.int32)
                    & 0x1FFF).any()
        full = kernels._unpack_tf32(flat, rows, cols, order)
        if i == 1:              # [score_w | remap_feat_w]: padded columns classes ... 23
            assert not full[:, classes:p].any()
            if remap:
                assert torch.equal(full[:, p:], t["remap_feat_w"])
        if i == 2:
            assert not full[classes:].any()
        at += 2 * rows * cols
    assert at == packed.numel()
    assert not biases[f + classes:f + p].any()


def _wgmma_b(flat, rows, cols):
    """A packed weight as the kernel's wgmma reads it: (hi, lo), each (rows,
    cols) with row 8s + 4kc + j the k slot (kc, j) of k step s (no channel
    order: the k order is what the A fragments must match)."""
    parts = flat.reshape(rows // 8, 2, cols // 8, 2, 8, 4)     # (s, hi|lo, grp, kc, col, j)
    return tuple(parts[:, i].permute(0, 2, 4, 1, 3).reshape(rows, cols) for i in range(2))


def _mma3(a, w_hi, w_lo, bias):
    """bias + a @ w as the kernel sums it: a_hi w_hi from the bias, then the
    small terms a_lo w_hi + a_hi w_lo, added once."""
    a_hi, a_lo = split_tf32(a)
    return (bias + a_hi @ w_hi) + (a_lo @ w_hi + a_hi @ w_lo)


def _kernel_model(f_in, y, packed, biases, classes):
    """The kernel's operand order and arithmetic in plain PyTorch.  Pixels in
    m64 blocks, the last block's rows past the end reading the last pixel (and
    not stored).  Lane t of a row reads channels 16j + 4t ... + 3 of f_in for
    k steps 2j and 2j + 1 (split4(x, x', y, y') for 2j, (z, z', w, w') for
    2j + 1): k slot (kc, j=t) of step s holds channel 16 (s // 2) + 4t + 2 (s % 2)
    + kc.  A product whose A is another's accumulator takes columns 8i + 2t,
    + 1 of it as slots (0, t), (1, t) of k step i.  With the remaps the score
    head and the remap of f are one product over [Ws | Wrf]."""
    n, h, w, f = f_in.shape
    p = n * h * w
    rows = torch.clamp(torch.arange(-(-p // 64) * 64), max=p - 1)
    x = f_in.reshape(p, f)[rows]
    s = torch.arange(f // 8)[:, None, None]
    kc = torch.arange(2)[None, :, None]
    t = torch.arange(4)[None, None, :]
    a = x[:, (16 * (s // 2) + 4 * t + 2 * (s % 2) + kc).reshape(-1)]

    def pair(v):                        # an accumulator as the A of the next product
        steps = v.shape[1] // 8
        i = torch.arange(steps)[:, None, None]
        return v[:, (8 * i + 2 * t + kc).reshape(-1)]

    kp = kernels.HEAD_CLASSES
    ns = kp + (f if y is not None else 0)            # [Ws | Wrf] with the remaps
    wf = _wgmma_b(packed[:2 * f * f], f, f)
    wsr = _wgmma_b(packed[2 * f * f:2 * f * (f + ns)], f, ns)
    bf, bsr = biases[:f], biases[f:f + ns]
    fm = torch.relu(_mma3(a, *wf, bf))
    acc = _mma3(pair(fm), *wsr, bsr)
    raw = acc[:, :kp]
    out = raw[:p, :classes].reshape(n, h, w, classes)
    if y is None:
        return out, None
    wrs = _wgmma_b(packed[2 * f * (f + ns):], kp, f)
    yr = y.reshape(p, f)[rows]
    sums = (yr + acc[:, kp:]) + _mma3(pair(raw), *wrs, biases[f + ns:])
    return out, sums[:p].reshape(n, h, w, f)


@pytest.mark.parametrize("shape,classes,remap", [
    ((1, 16, 32), 19, True),        # 512 pixels: whole m64 blocks
    ((1, 16, 32), 19, False),
    ((3, 7, 11), 19, True),         # 231 pixels: a last block of 39
    ((1, 1, 5), 24, True),          # one partial block, no padded class
    ((2, 3, 9), 3, False),
])
def test_kernel_model_matches_plain(fly, shape, classes, remap):
    """The kernel's operand order, padding and tail with its 3xTF32 sums give
    the plain chain within 5e-5 of the outputs' size (a slot off by one
    channel, or a class read from the padding, would be off by their size)."""
    if classes == 19:
        t = fly.stacks[0 if remap else 1]
        packed, biases = t.head_packed, t.head_biases
    else:
        packed, biases = kernels.pack_heads(_stack(96, classes, remap, classes))
    f_in, y = _inputs(shape, 96, remap, 7)
    want_out, want_y = _run(kernels.stack_heads_plain, f_in, y, packed, biases, classes)
    got_out, got_y = _kernel_model(f_in, y, packed, biases, classes)
    assert (got_out - want_out).abs().max().item() <= 5e-5 * max(1.0, want_out.abs().max().item())
    if remap:
        assert (got_y - want_y).abs().max().item() <= 5e-5 * max(1.0, want_y.abs().max().item())


def test_kernel_model_fails_a_one_channel_shift(fly):
    """The model is strict enough to catch a gather off by one channel."""
    t = fly.stacks[0]
    f_in, y = _inputs((1, 4, 16), 96, True, 8)
    want, _ = _run(kernels.stack_heads_plain, f_in, y, t.head_packed, t.head_biases, 19)
    got, _ = _kernel_model(torch.roll(f_in, 1, dims=3), y, t.head_packed, t.head_biases, 19)
    assert (got - want).abs().max().item() > 100 * 5e-5 * max(1.0, want.abs().max().item())


def test_refusals_off_the_cpu():
    """Off the CPU the wrapper refuses a width or class count that is no
    instance, naming the instances, before it looks for a card (here: tensors
    on the meta device); mixed devices and shapes are refused anywhere."""
    assert kernels.HEAD_WIDTHS == (96,) and kernels.HEAD_CLASSES == 24
    for f, k, match in ((64, 19, r"F in \(96,\), not 64"), (128, 17, r"F in \(96,\), not 128"),
                        (96, 25, "1 to 24 classes, not 25"), (96, 19, "runs on cuda or cpu")):
        packed, biases = kernels.pack_heads(_stack(f, min(k, 24), True, 0))
        x = torch.zeros((1, 2, 2, f), device="meta")
        out = torch.zeros((1, 2, 2, k), device="meta")
        with pytest.raises(ValueError, match=match):
            kernels.stack_heads(x, x, packed.to("meta"), biases.to("meta"), out)
    with pytest.raises(ValueError, match="at most 24 classes"):
        kernels.pack_heads(_stack(96, 25, False, 0))
    packed, biases = kernels.pack_heads(_stack(96, 19, True, 0))
    x = torch.zeros((1, 2, 2, 96))
    out = torch.zeros((1, 2, 2, 19))
    with pytest.raises(ValueError, match="one device"):
        kernels.stack_heads(x, x, packed.to("meta"), biases, out)
    with pytest.raises(ValueError):
        kernels.stack_heads(x, x, packed, biases, torch.zeros((1, 2, 3, 19)))
    with pytest.raises(ValueError):
        kernels.stack_heads(x, torch.zeros((1, 2, 2, 48)), packed, biases, out)
    with pytest.raises(ValueError, match="not the heads"):      # the last stack's buffers
        kernels.stack_heads(x, None, packed, biases, out)


def _counted(net):
    calls = []

    def head_fn(f_in, y, packed, biases, out):
        calls.append((tuple(f_in.shape), y is None, out.shape[-1]))
        return kernels.stack_heads_plain(f_in, y, packed, biases, out)

    net.head_fn = head_fn
    return calls


def test_fly_net_runs_each_stack_through_head_fn(fly):
    """The 2-stack 96-wide float32 fly net calls ``head_fn`` once a stack (the
    last without y) and gives the bits of the chain it replaced, in one
    output tensor; ``pipeline.plain_twin`` swaps in ``stack_heads_plain``."""
    import copy
    import pickle

    import numpy as np

    from deepfly3d_torch.ops import geometry
    from deepfly3d_torch.pipeline import build_pipeline, plain_twin

    assert fly.heads_fused and fly.head_fn is kernels.stack_heads
    net = copy.copy(fly)
    calls = _counted(net)
    x = torch.rand((1, 64, 128, 3), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = net(x)
        old = copy.copy(fly)
        old.heads_fused = False
        want = old(x)
    assert calls == [((1, 16, 32, 96), False, 19), ((1, 16, 32, 96), True, 19)]
    assert got.shape == (2, 1, 16, 32, 19) and torch.equal(got, want)

    variables, spec = load_weights(CHECKPOINT)
    with open(os.path.join(REPO, "data", "calib.pkl"), "rb") as f:
        calib = geometry.calib_to_arrays(pickle.load(f), 7, dtype=np.float32)
    pipe = build_pipeline(spec, variables, calib, list(range(7)), rig=None, device="cpu")
    assert pipe.net.head_fn is kernels.stack_heads
    assert plain_twin(pipe).net.head_fn is kernels.stack_heads_plain


def _net(path, **replace):
    variables, spec = load_weights(path)
    spec = dataclasses.replace(spec, **replace)
    return FoldedHourglass(fold_hourglass(variables, spec), spec)


@pytest.mark.parametrize("case", ["bf16", "score_ksize3", "head_upsample2", "features256",
                                  "patchify96"])
def test_head_fn_only_for_float32_96_wide_1x1_heads(tmp_path, case):
    """Never for a bf16 net, a 3x3 or upsampled score head or 256 features; a
    1-stack 96-wide 1x1 net (the cascade's student) calls it once, without y."""
    from deepfly3d_torch.utils.synthetic import random_checkpoint

    x = torch.rand((1, 64, 128, 3), generator=torch.Generator().manual_seed(4))
    if case == "bf16":
        net = _net(CHECKPOINT, compute_dtype="bfloat16")
    elif case == "score_ksize3":
        net = _net(os.path.join(WEIGHTS, "hourglass_fly_tpu.npz"))
    elif case == "head_upsample2":
        net = _net(os.path.join(WEIGHTS, "hourglass_fly_p16.npz"))
        x = torch.rand((1, 128, 256, 3), generator=torch.Generator().manual_seed(4))
    elif case == "patchify96":
        net = _net(os.path.join(WEIGHTS, "hourglass_fly_fast_nearparity.npz"))
    else:
        path = str(tmp_path / "w256.npz")
        random_checkpoint(path, 0, num_stacks=2, features=256, depth=1, num_classes=19,
                          input_shape=(32, 64))
        net = _net(path)
        x = x[:, :32, :64]
    calls = _counted(net)
    with torch.inference_mode():
        out = net(x)
    if case == "patchify96":
        assert net.heads_fused and calls == [((1, 16, 32, 96), True, 19)]
    else:
        assert not net.heads_fused and calls == []
        assert not any(hasattr(s, "head_packed") for s in net.stacks)
    assert out.dtype == torch.float32 and out.shape[-1] == 19


def test_kernel_name_stays_out_of_the_roofline_and_glue_selectors():
    """The head kernel counts as network glue: its symbols hold none of the
    substrings that select the bottleneck and preprocess rooflines and the
    glue's exclusions."""
    with open(SOURCE) as f:
        text = f.read()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+"      # one level of parentheses
    names = re.findall(r"__global__\s+void\s+(?:" + bounds + r")?(\w+)", text)
    entries = re.findall(r"^int\s+(\w+)\(", text, flags=re.M)
    assert names == ["stack_heads_kernel"]
    assert "df3d_stack_heads" in entries
    for name in names + entries:
        assert not any(s in name for s in ("bottleneck", "preprocess", "upsample2x_add"))
