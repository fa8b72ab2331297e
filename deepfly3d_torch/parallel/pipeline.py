"""Sharded pipeline steps over a ``mesh.Mesh``.

Counterpart of ``deepfly3d_tpu/parallel/pipeline.py``:

* data-parallel inference (images split over ``data``): one forward per mesh
  entry, through the preprocess, bottleneck, upsample-add and decode kernels
  on a card (their plain versions on the CPU), no collective;
* frame-sharded triangulation;
* batched Levenberg-Marquardt over recordings: N bundle adjustments in one
  batched solve (``ops/bundle_adjust._lm_solve_batched``).

The data-parallel training step waits on the trainable network
(``make_sharded_train_step`` raises).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import HourglassSpec
from deepfly3d_torch.models.inference import infer_batch
from deepfly3d_torch.ops import geometry
from deepfly3d_torch.parallel import mesh as mesh_mod
from deepfly3d_torch.utils.devices import full_f32, resolve_device


def _on(dev: torch.device):
    """The device guard of one mesh entry's launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _gather(outs, mesh: mesh_mod.Mesh, axis_name: str, device) -> torch.Tensor:
    """[(entry index, output)] -> the outputs concatenated on ``device``, one
    entry per index of ``axis_name`` (entries that differ only along another
    mesh axis hold copies)."""
    keep = [out for index, out in outs
            if all(i == 0 for i, name in zip(index, mesh.axis_names) if name != axis_name)]
    return torch.cat([out.to(device) for out in keep])


# ------------------------------------------------------------- training step


def make_sharded_train_step(spec: HourglassSpec, mesh: mesh_mod.Mesh,
                            learning_rate: float = 1e-3, axis_name: str = "data"):
    """The data-parallel training step (batch-norm statistics in training
    mode, gradients averaged over the mesh) needs a trainable network; the
    port has the folded inference forward only."""
    raise NotImplementedError(
        "make_sharded_train_step needs the trainable HourglassNet (training-mode batch "
        "norm), which the port does not have yet: ROADMAP.md Queue 1 item 1 (training)")


# ------------------------------------------------------------ inference step


def make_sharded_infer(spec: HourglassSpec, mesh: mesh_mod.Mesh, input_shape: Tuple[int, int],
                       axis_name: str = "data"):
    """Data-parallel inference: (N, H, W, 3) uint8 + (N,) flips, split over
    ``axis_name`` (N must divide evenly).

    -> ``infer(variables, images_u8, flip)`` -> (pts (N, K, 2), conf (N, K, 1))
    on the host: the per-image math of ``models.inference.infer_batch``
    (preprocess, folded hourglass, argmax decode) with one forward per mesh
    entry on its block.  ``variables`` is the tree ``load_weights`` returns;
    it is folded once per entry and the replica kept on that entry's device
    until other variables come.  Every entry's copy and launches are queued
    before any result is read back, so entries on separate cards overlap.
    """
    full_f32()
    input_shape = tuple(input_shape)
    held = {"variables": None, "nets": []}      # the replicas and what they were folded from

    def nets(variables):
        if held["variables"] is not variables:
            held.update(variables=variables, nets=[
                FoldedHourglass(fold_hourglass(variables, spec), spec).to(dev).eval()
                for dev in mesh.devices.flat])
        return held["nets"]

    def infer(variables, images_u8, flip):
        images = mesh_mod.blocks(images_u8, mesh_mod.batch_sharding(mesh, 4, axis_name))
        flips = mesh_mod.blocks(np.asarray(flip, bool),
                                mesh_mod.batch_sharding(mesh, 1, axis_name))
        outs = []
        for net, (index, dev, x), (_, _, f) in zip(nets(variables), images, flips):
            with _on(dev):
                outs.append((index, infer_batch(net, x.to(dev), f.to(dev), input_shape)))
        return tuple(_gather([(index, out[k]) for index, out in outs], mesh, axis_name, "cpu")
                     for k in range(2))

    return infer


# --------------------------------------------------- frame-sharded geometry


def make_sharded_triangulate(mesh: mesh_mod.Mesh, image_shape, axis_name: str = "data"):
    """Triangulation with the frame axis split over ``axis_name``.

    -> ``tri(points2d (C, T, J, 2), R, tvec, intr)`` -> (T, J, 3) on the
    device of ``points2d`` (the host for numpy): each entry runs
    ``geometry.triangulate`` (``"svd"``, the JAX default) on its frames; the
    DLT of every (frame, joint) is independent, so no collective.
    """
    def tri(points2d, R, tvec, intr):
        points2d = torch.as_tensor(points2d)
        p2 = mesh_mod.blocks(points2d, mesh_mod.Sharding(mesh, (None, axis_name)))
        cams = mesh_mod.replicate(mesh, (R, tvec, intr))
        outs = []
        for (index, dev, p), (R_d, t_d, K_d) in zip(p2, cams):
            with _on(dev):
                outs.append((index, geometry.triangulate(p.to(dev), R_d, t_d, K_d,
                                                         image_shape)))
        return _gather(outs, mesh, axis_name, points2d.device)

    return tri


# ------------------------------------------------- batched LM over recordings


def make_batched_calibration(image_shape, max_iters: int = 20, device="cuda"):
    """Levenberg-Marquardt over N recordings in one batched solve.

    -> ``calibrate(cams0 (B, C, 6), pts0 (B, N, 3), K (B, C, 3, 3), dist
    (B, C, 5), obs (B, C, N, 2), mask (B, C, N))`` -> (cams, pts, cost0,
    cost, iters) on ``device``, per member what its own ``_lm_solve`` gives.
    The inputs (numpy or tensors) are moved to ``device``: the card by
    default, the CPU only when asked for.
    """
    from deepfly3d_torch.ops.bundle_adjust import _lm_solve_batched

    dev = resolve_device(device)

    def calibrate(cams0, pts0, K, dist, obs, mask):
        args = [(a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a)))
                .to(dev) for a in (cams0, pts0, K, dist, obs, mask)]
        with torch.no_grad():
            return _lm_solve_batched(*args, max_iters=max_iters)

    return calibrate
