"""Multi-recording fleet processing.

Counterpart of ``deepfly3d_tpu/parallel/fleet.py``.  The reference's only
batch mechanism is a serial loop over folders; here

1. every recording's images are decoded on the host (native libjpeg thread
   pool, else OpenCV threads) and go through **one** inference pass: the
   estimator's batched loop on one device, or one forward per entry of a
   ``mesh.Mesh`` (``pipeline.make_sharded_infer``), the images padded to a
   multiple of the mesh size with the first images;
2. the 19->38 assembly, bundle adjustment, triangulation and Procrustes
   then run per recording, with the CLI batch loop's isolation: one bad
   recording never stops the others;
3. each recording gets a reference-schema ``df3d_result_*.pkl``.

As in the JAX package the fleet does no rig registration.  For fleets of
already-detected 2D points, ``pipeline.make_batched_calibration`` runs N
bundle adjustments in one batched solve.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepfly3d_torch import logger
from deepfly3d_torch.config import Config, fly_config


@dataclass
class RecordingResult:
    folder: str
    ok: bool
    error: Optional[Exception] = None
    points2d: Optional[np.ndarray] = None        # (C, T, 38, 2) normalized
    conf: Optional[np.ndarray] = None
    points3d: Optional[np.ndarray] = None        # (T, 38, 3) post-procrustes
    calib: Optional[Dict[int, dict]] = None
    save_path: Optional[str] = None


def process_recordings(
    folders: Sequence[str],
    checkpoint: Optional[str] = None,
    mesh=None,
    config: Optional[Config] = None,
    batch_size: int = 8,
    solver: str = "lm",
    num_images_max: int = 0,
    save: bool = True,
    camera_ordering: Optional[Sequence[int]] = None,
    device="cuda",
    **solver_kwargs,
) -> List[RecordingResult]:
    """Process N recordings with one shared inference pass.

    ``mesh``: an optional ``mesh.Mesh``; the images split over its entries
    (padded to a multiple of its size).  Without it the network runs on
    ``device`` (``PoseEstimator.infer_images`` in batches of
    ``batch_size``).  ``solver``: "lm" (the default for fleets) or
    "parity"; extra ``solver_kwargs`` (e.g. ``huber_px``) go to
    ``ops.bundle_adjust`` per recording.
    """
    from deepfly3d_torch.core import Core, find_default_camera_ordering
    from deepfly3d_torch.io import discovery
    from deepfly3d_torch.models import decode as decode_mod
    from deepfly3d_torch.models.hourglass import load_weights
    from deepfly3d_torch.models.inference import PoseEstimator, _read_images_threaded

    cfg = config or fly_config()
    ckpt = checkpoint or cfg.network.checkpoint
    C = cfg.num_cameras

    results = [RecordingResult(folder=f, ok=False) for f in folders]

    # ---- 1. discover + decode every recording's images on the host
    all_paths: List[str] = []
    all_flips: List[bool] = []
    spans: List[Optional[tuple]] = []  # (start, T, ordering) per recording
    for rec in results:
        try:
            if camera_ordering is not None:
                ordering = np.asarray(camera_ordering)
            else:
                try:
                    ordering = find_default_camera_ordering(rec.folder)
                except NotImplementedError:
                    ordering = np.arange(C)
            T = discovery.get_max_img_id(rec.folder) + 1
            if num_images_max:
                T = min(T, num_images_max)
            flip_cams = {int(ordering[i]) for i in range(4, C)}
            start = len(all_paths)
            for cam in range(C):
                for img in range(T):
                    all_paths.append(os.path.join(rec.folder, f"camera_{cam}_img_{img}.jpg"))
                    all_flips.append(cam in flip_cams)
            spans.append((start, T, ordering))
        except Exception as e:  # noqa: BLE001 -- per-recording isolation
            rec.error = e
            spans.append(None)
            logger.warning(f"{rec.folder}: discovery failed: {e}")

    if not all_paths:
        return results

    images = _read_images_threaded(all_paths)
    flips = np.asarray(all_flips)

    # ---- 2. ONE inference pass over every image of every recording
    if mesh is not None:
        from deepfly3d_torch.parallel.pipeline import make_sharded_infer

        variables, spec = load_weights(ckpt)
        input_shape = spec.input_shape or cfg.network.input_shape
        pad = (-images.shape[0]) % mesh.size
        if pad:
            images = np.concatenate([images, images[:pad]])
            flips = np.concatenate([flips, flips[:pad]])
        infer = make_sharded_infer(spec, mesh, input_shape)
        pts_all, conf_all = infer(variables, images, flips)
        pts_all = pts_all.numpy()[: len(all_paths)]
        conf_all = conf_all.numpy()[: len(all_paths)]
    else:
        estimator = PoseEstimator(ckpt, input_shape=cfg.network.input_shape, device=device)
        pts_all, conf_all = estimator.infer_images(images, flips, batch_size=batch_size)

    # ---- 3. per-recording geometry + save, isolated
    for rec, span in zip(results, spans):
        if span is None:
            continue
        try:
            start, T, ordering = span
            n = C * T
            K = pts_all.shape[1]
            pts19 = pts_all[start:start + n].reshape(C, T, K, 2).astype(np.float64)
            conf = conf_all[start:start + n].reshape(C, T, K, 1).astype(np.float64)
            core = Core(input_folder=rec.folder, output_folder=None, num_images_max=T,
                        camera_ordering=list(ordering), device=device)
            core.points2d = decode_mod.postprocess_points2d(
                pts19, core.camera_ordering, cfg.num_joints)
            core.conf = conf
            core.calibrate_calc(0, T - 1, solver=solver, **solver_kwargs)
            if save:
                core.save()
                rec.save_path = core.save_path
            rec.points2d = core.points2d
            rec.conf = conf
            rec.points3d = core.points3d if save else None
            rec.calib = core.calib
            rec.ok = True
        except Exception as e:  # noqa: BLE001 -- per-recording isolation
            rec.error = e
            logger.warning(f"{rec.folder}: processing failed: {e}")
    failed = [r for r in results if not r.ok]
    if failed:
        logger.warning(f"{len(failed)} of {len(results)} recordings failed: "
                       + ", ".join(r.folder for r in failed))
    return results
