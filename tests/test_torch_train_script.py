"""``python -m deepfly3d_torch.train_fly_weights`` end to end on the CPU.

At a tiny width and 64x128 over the bundled recording, the eval through
the serving path with every kernel's plain version: a fresh network with
shift and gain augmentation, then resumed with frozen statistics and the
envelope pool, then distilled, then a fresh network at bfloat16 (its evals
through the unfolded bf16 network); each run writes a checkpoint that both
packages read, and parity fails at this size (exit 1).  No width check is left: on
a card the evals run every block of the toy width in the bottleneck kernel's
general instance.
"""

import os

import pytest
import torch

from deepfly3d_tpu.models import hourglass as jax_hg
from deepfly3d_torch.models import hourglass as port_hg


@pytest.fixture(autouse=True)
def _few_threads():
    """2 intra-op threads: the suite runs 6 workers on the cores, and 8
    threads each oversubscribe them.  Restored after the test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_fly_weights_script_on_the_cpu(tmp_path, capsys):
    from deepfly3d_torch import train_fly_weights as script

    out = str(tmp_path / "tiny.npz")
    base = ["--input", "64x128", "--device", "cpu", "--out", out, "--batch-size", "8",
            "--steps", "2"]
    assert script.main(base + ["--features", "16", "--stacks", "1", "--depth", "2",
                               "--shift-aug", "2", "--gain-aug", "0.05"]) == 1
    _, pspec = port_hg.load_weights(out)
    _, jspec = jax_hg.load_weights(out)
    assert pspec.input_shape == jspec.input_shape == (64, 128) and pspec.features == 16
    assert script.main(base + ["--resume", "--freeze-bn", "--augment-envelope"]) == 1
    assert script.main(base + ["--resume", "--distill-teacher", out]) == 1
    text = capsys.readouterr().out
    assert "augment-envelope pool: 945 images" in text and "distilling from" in text
    assert "PARITY: FAIL" in text and not os.path.exists(out + ".PARITY")
    bf16_out = str(tmp_path / "tiny_bf16.npz")
    assert script.main(["--input", "64x128", "--device", "cpu", "--out", bf16_out,
                        "--batch-size", "8", "--steps", "2", "--features", "16", "--stacks", "1",
                        "--depth", "2", "--dtype", "bfloat16"]) == 1
    assert jax_hg.load_weights(bf16_out)[1].features == 16
    # --features 16 gets past the width check, which is gone: every block of
    # the toy spec has a kernel on the card (the general instance)
    assert not hasattr(script, "check_kernel_widths")
    from deepfly3d_torch.models.fused_inference import fold_hourglass
    from deepfly3d_torch.ops import bottleneck as bn

    blocks = fold_hourglass(*port_hg.load_weights(out))["blocks"].values()
    assert {bn.kernel_for(b["w1"].shape[0], b["w1"].shape[1], b["w3"].shape[1], "wp" in b)
            for b in blocks} == {"general"}
