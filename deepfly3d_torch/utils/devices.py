"""Device placement for the port.

Entry points default to ``"cuda"`` and never carry on silently on the CPU:
asking for a card that is not there raises.  ``"cpu"`` is an explicit
choice (the tests make it), on which every kernel wrapper runs its plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked.

    Raises RuntimeError when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False, and ValueError for a device
    type the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def full_f32() -> None:
    """Run every float32 matmul and convolution in full float32.

    cuDNN convolutions default to TF32 (``cudnn.allow_tf32`` is True out of
    the box), which keeps ~3 decimal digits; the golden confidence band has
    9e-6 of headroom at the shipped checkpoint, so the port turns TF32 off
    for both matmuls and convolutions wherever a pipeline is built.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
