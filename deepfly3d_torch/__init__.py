"""deepfly3d_torch — the PyTorch/CUDA port of deepfly3d_tpu for NVIDIA Hopper.

The port runs the 2D->3D inference path (7 cameras of 480x960 uint8
frames -> rig registration -> /255, flip and resize -> stacked hourglass ->
argmax decode -> 19->38 assembly -> masked DLT triangulation) on an H100,
for every shipped checkpoint, and the student + parity-repair cascade
(``models/cascade.py``), and the recording entry point: ``python -m
deepfly3d_torch.cli RECORDING`` (``core.Core``: JPEG or video ingest with the
per-recording rig registration, parity bundle adjustment, float64
triangulation and Procrustes, the JAX package's result pickle).  Every
frame preprocess, bottleneck block, hourglass level merge and heatmap
decode runs in a CUDA kernel written by hand for ``sm_90a``
(``ops/csrc``); the glue between them (stem and score
convolutions, max-pools, 1x1 heads, depth-to-space) is plain PyTorch in
full float32.

The package imports ``torch`` and never ``jax`` or ``deepfly3d_tpu``: the
JAX package is the reference the port is tested against, and its import
turns on JAX's x64 mode.  Entry points take ``device`` (default ``"cuda"``)
and raise when no card is present; the tests pass ``device="cpu"``, where
each kernel wrapper runs its plain PyTorch version.

Layouts follow the JAX package at every public function: NHWC activations,
(C, T, 38, 2) points and (C, T, 19, 1) confidences.  As in the JAX package,
the network runs on the accelerator and the float64 geometry (triangulation,
bundle adjustment, Procrustes, filtering) on the host CPU.
"""

__version__ = "0.1.0"
