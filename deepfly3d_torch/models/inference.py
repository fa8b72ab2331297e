"""Batched 2D pose inference over frames, a folder of JPEGs or camera videos.

Counterpart of ``deepfly3d_tpu/models/inference.py``: ``infer_batch``,
``PoseEstimator.infer_images``, ``infer_folder`` and ``infer_videos`` with
the per-recording rig registration of the ingest paths.  The JAX package
prefetches the next batch with an asynchronous ``jax.device_put``; here the
next batch is copied from pinned host memory on a side CUDA stream while
the current one computes.

Rig registration on ingest (``_register_chunk``): per camera, (dy, dx, gain)
is estimated once per recording on the host, from the first chunk in which
the camera has at least ``MIN_EST_FRAMES`` frames (``estimate_camera_np``,
as the JAX package does it; a shorter first chunk caches the identity).  The
JAX package then rolls the frames on the host; the port hands every image's
(dy, dx) to the preprocess kernel, whose circular shift is that roll bit for
bit, so no frame is copied.  The gain the kernel multiplies by is the
*measured* gain, as the JAX ingest path multiplies by it (not by its
inverse, which the device pipelines use): a quirk of the reference that the
port reproduces (ROADMAP.md Queue 3).

Output contract: points (N, 19, 2) normalized (row, col) — flipped images
stay in the flipped frame, registered ones are moved to the provided frame —
and confidences (N, 19, 1); the folder and video paths stack them per camera
as (C, T, 19, 2) / (C, T, 19, 1) float64.
"""

from __future__ import annotations

import concurrent.futures as futures
import contextlib
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepfly3d_torch import logger
from deepfly3d_torch.config import fly_config
from deepfly3d_torch.io import discovery, native
from deepfly3d_torch.models import decode as decode_mod
from deepfly3d_torch.models.fused_inference import FoldedHourglass, fold_hourglass
from deepfly3d_torch.models.hourglass import load_weights
from deepfly3d_torch.ops import canonicalize
from deepfly3d_torch.ops import image as image_ops
from deepfly3d_torch.utils.devices import full_f32, resolve_device


@torch.inference_mode()
def infer_batch(net: FoldedHourglass, images_u8: torch.Tensor, flip: torch.Tensor,
                input_shape: Tuple[int, int], gain: Optional[torch.Tensor] = None,
                shift=None, return_heatmaps: bool = False,
                preprocess=image_ops.preprocess_frames, decode=decode_mod.decode_argmax):
    """(N, H, W, 3) uint8 on the net's device -> (pts (N, K, 2), conf (N, K, 1)),
    plus the last stack's (N, h, w, K) heatmaps with ``return_heatmaps``.

    ``shift`` = (dy, dx), (N,) int32 each, and ``gain``, (N,) float32, are
    applied by the preprocess: the frames rolled by (-dy, -dx) as it reads
    them, the network input times ``gain`` as it writes.  ``preprocess`` and
    ``decode`` are the stages (the kernels' wrappers, or their plain versions).
    """
    x = preprocess(images_u8, flip, tuple(input_shape), net.spec.preprocess_dtype,
                   shift=shift, gain=gain)
    heatmaps = net(x)[-1]
    pts, conf = decode(heatmaps)
    return (pts, conf, heatmaps) if return_heatmaps else (pts, conf)


def _read_images_threaded(paths: Sequence[str], workers: int = 16) -> np.ndarray:
    """Decode JPEGs -> (N, H, W, 3) uint8: the native libjpeg thread pool when
    it loads, else a Python thread pool over OpenCV (the JAX package's order)."""
    if native.available() and paths:
        probe = discovery.read_image(paths[0])
        try:
            return native.decode_jpeg_batch(
                list(paths), probe.shape[0], probe.shape[1], num_threads=workers
            )
        except (IOError, RuntimeError) as e:
            logger.warning(f"native decode failed ({e}), falling back to cv2")

    out = [None] * len(paths)

    def job(i):
        out[i] = discovery.read_image(paths[i])

    with futures.ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(job, range(len(paths))))
    return np.stack(out)


def _video_frames(path: str):
    """RGB uint8 frames of one video: native libav when it loads, else OpenCV."""
    if native.available():
        with native.VideoReader(path) as vr:
            yield from vr
        return
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def _concat(parts: List[tuple]) -> tuple:
    return tuple(np.concatenate(arrays, axis=0) for arrays in zip(*parts))


class PoseEstimator:
    """Loads a checkpoint once and runs batched inference on ``device``.

    Takes every shipped checkpoint (conv, patchify, patch8 and patch16 stems;
    1x1 and 3x3 score heads; subpixel heads).  The input shape is the
    checkpoint's own ``input_shape`` when it has one, else ``input_shape``,
    else the config's.  ``rig_template``: ``"auto"`` finds the template shipped
    beside the checkpoint, a path loads that one, None (or "off") turns the
    ingest paths' registration off.  ``soft_argmax`` decodes sub-cell points
    (``decode.decode_softargmax``); the registration's un-shift then moves
    the refined points.

    ``net`` (the folded hourglass), ``preprocess`` and ``decode`` are the
    stages, as on a ``pipeline.Pipeline``: ``pipeline.plain_twin`` swaps
    them for their plain versions.
    """

    def __init__(self, checkpoint: str, input_shape: Optional[Tuple[int, int]] = None,
                 device="cuda", rig_template: Optional[str] = "auto",
                 soft_argmax: bool = False):
        self.device = resolve_device(device)
        full_f32()
        variables, self.spec = load_weights(checkpoint)
        self.net = FoldedHourglass(fold_hourglass(variables, self.spec),
                                   self.spec).to(self.device).eval()
        self.preprocess = image_ops.preprocess_frames
        # soft-argmax: the decode kernel's cells, refined on a patch around each
        self.decode = (decode_mod.SoftArgmaxDecode() if soft_argmax
                       else decode_mod.decode_argmax)
        # the checkpoint's training resolution is the source of truth
        self.input_shape = tuple(self.spec.input_shape or input_shape
                                 or fly_config().network.input_shape)
        if rig_template == "auto":
            rig_template = canonicalize.find_template(checkpoint)
        elif rig_template in (None, "", "off"):
            rig_template = None
        self.rig = canonicalize.load_template(rig_template) if rig_template else None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def nets(self) -> dict:
        """The folded hourglasses this estimator runs, by attribute name."""
        return {"net": self.net}

    def _stage(self, arrays: List[Optional[np.ndarray]]):
        """Start the host-to-device copy of one batch; -> (tensors, keepalive, event).

        On a card the arrays go through pinned host memory on the side
        stream, so the copy overlaps the compute queued on the current one.
        """
        if self._copy_stream is None:
            return [None if a is None else torch.from_numpy(a) for a in arrays], None, None
        host = [None if a is None else torch.from_numpy(a).pin_memory() for a in arrays]
        with torch.cuda.stream(self._copy_stream):
            dev = [None if h is None else h.to(self.device, non_blocking=True)
                   for h in host]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, host, done

    def _wait(self, staged):
        tensors, _, done = staged
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in tensors:
                if t is not None:
                    t.record_stream(current)
        return tensors

    def infer_images(self, images_u8: np.ndarray, flip: np.ndarray,
                     batch_size: int = 8, gain: Optional[np.ndarray] = None,
                     return_heatmaps: bool = False, shift=None):
        """(N, H, W, 3) uint8 + (N,) flip flags -> (pts (N, 19, 2), conf (N, 19, 1)),
        plus (N, h, w, 19) last-stack heatmaps with ``return_heatmaps`` (flipped
        images in the flipped frame, registered ones in the canonical frame).

        The last batch is padded with the first images (and the padding
        dropped), so every batch has ``batch_size`` images.  ``gain`` (N,)
        and ``shift`` = (dy (N,), dx (N,)) are the rig registration's, applied
        by the preprocess; all-ones and all-zeros are the same as None.
        """
        N = images_u8.shape[0]
        pad = (-N) % batch_size
        images_u8 = np.ascontiguousarray(images_u8, np.uint8)
        flip = np.asarray(flip, bool)
        per_image = [gain, None, None] if shift is None else [gain, *shift]
        if gain is not None and np.all(np.asarray(gain) == 1.0):
            per_image[0] = None              # identity: no gain tensor to copy
        if shift is not None and not (np.any(shift[0]) or np.any(shift[1])):
            per_image[1:] = [None, None]
        per_image = [None if a is None else np.asarray(a, dt)
                     for a, dt in zip(per_image, (np.float32, np.int32, np.int32))]
        if pad:
            images_u8 = np.concatenate([images_u8, images_u8[:pad]], axis=0)
            flip = np.concatenate([flip, flip[:pad]], axis=0)
            per_image = [None if a is None else np.concatenate([a, a[:pad]])
                         for a in per_image]

        def batch(i):
            sl = slice(i, i + batch_size)
            return self._stage([np.ascontiguousarray(images_u8[sl]),
                                np.ascontiguousarray(flip[sl])]
                               + [None if a is None else np.ascontiguousarray(a[sl])
                                  for a in per_image])

        outs = []
        starts = list(range(0, images_u8.shape[0], batch_size))
        staged = batch(starts[0])
        for n in range(len(starts)):
            imgs, fl, g, dy, dx = self._wait(staged)
            if n + 1 < len(starts):
                staged = batch(starts[n + 1])      # next copy in flight
            out = infer_batch(self.net, imgs, fl, self.input_shape, g,
                              None if dy is None else (dy, dx), return_heatmaps,
                              self.preprocess, self.decode)
            outs.append(tuple(t.cpu().numpy() for t in out))
        return tuple(a[:N] for a in _concat(outs))

    def _register_chunk(self, images: np.ndarray, cams: np.ndarray, reg: dict):
        """Rig registration of one ingest chunk -> (gain (N,) float32 or None,
        dy (N,), dx (N,)) per image.

        ``reg`` caches each camera's (dy, dx, gain) for the recording: it is
        estimated from the first chunk in which the camera appears, and is
        the identity when that chunk holds fewer than ``MIN_EST_FRAMES`` of
        its frames.  Nothing is estimated without a template or when the
        frames are not the template's size.
        """
        zeros = np.zeros(len(cams), np.int64)
        if self.rig is None or images.shape[1:3] != self.rig.image_hw:
            return None, zeros, zeros
        cams = np.asarray(cams)
        for cam in np.unique(cams):
            if int(cam) not in reg:
                cam_frames = images[cams == cam]
                if len(cam_frames) < canonicalize.MIN_EST_FRAMES:
                    reg[int(cam)] = (0, 0, 1.0)
                else:
                    reg[int(cam)] = canonicalize.estimate_camera_np(
                        cam_frames, self.rig, int(cam))
        dy = np.array([reg[int(c)][0] for c in cams], np.int64)
        dx = np.array([reg[int(c)][1] for c in cams], np.int64)
        gain = np.array([reg[int(c)][2] for c in cams], np.float32)
        return (None if np.all(gain == 1.0) else gain), dy, dx

    def infer_chunks(self, chunks: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                     batch_size: int = 8, return_heatmaps: bool = False,
                     registration: Optional[dict] = None):
        """The ingest loop of ``infer_folder`` and ``infer_videos``.

        ``chunks`` yields (images (n, H, W, 3) uint8, cams (n,), flip (n,)).
        Each chunk is registered (``_register_chunk``, caching into
        ``registration``), inferred with its per-image shift and gain, and its
        points moved to the provided frame (``adjust_points_raw``).  Returns
        the concatenated (pts (N, K, 2), conf (N, K, 1)[, heatmaps]).
        """
        reg = {} if registration is None else registration
        parts = []
        for images, cams, flip in chunks:
            gain, dy, dx = self._register_chunk(images, cams, reg)
            shifted = bool(np.any(dy) or np.any(dx))
            out = self.infer_images(images, flip, batch_size, gain=gain,
                                    return_heatmaps=return_heatmaps,
                                    shift=(dy, dx) if shifted else None)
            if shifted:
                out = (canonicalize.adjust_points_raw(out[0], dy, dx, flip,
                                                      self.rig.image_hw),) + out[1:]
            parts.append(out)
        return _concat(parts)

    def infer_folder(self, folder: str, camera_ids_to_flip: Sequence[int], max_img_id: int,
                     batch_size: int = 8, num_cameras: int = 7,
                     return_heatmap: bool = False, chunk_images: int = 512):
        """``camera_{c}_img_{t}.jpg`` files -> (points2d (C, T, 19, 2), conf
        (C, T, 19, 1)) float64, T = max_img_id + 1; with ``return_heatmap`` a
        third array (C, T, h, w, 19).

        At most ``chunk_images`` decoded frames (rounded down to a multiple
        of ``batch_size``, so chunking never changes a batch) are held at once.
        """
        T = max_img_id + 1
        paths = [os.path.join(folder, f"camera_{cam}_img_{img}.jpg")
                 for cam in range(num_cameras) for img in range(T)]
        cams = np.repeat(np.arange(num_cameras), T)
        flips = np.isin(cams, list(camera_ids_to_flip))
        chunk = max(chunk_images - chunk_images % batch_size, batch_size)

        def chunks():
            for lo in range(0, len(paths), chunk):
                yield (_read_images_threaded(paths[lo:lo + chunk]), cams[lo:lo + chunk],
                       flips[lo:lo + chunk])

        out = self.infer_chunks(chunks(), batch_size, return_heatmap)
        K = out[0].shape[1]
        result = (out[0].reshape(num_cameras, T, K, 2).astype(np.float64),
                  out[1].reshape(num_cameras, T, K, 1).astype(np.float64))
        if return_heatmap:
            return result + (out[2].reshape((num_cameras, T) + out[2].shape[1:]),)
        return result

    def infer_videos(self, folder: str, camera_ids_to_flip: Sequence[int],
                     batch_size: int = 8, num_cameras: int = 7,
                     max_frames: Optional[int] = None, chunk_frames: int = 512):
        """``camera_{c}.mp4`` streamed -> (points2d (C, T, 19, 2), conf (C, T, 19, 1))
        float64, T the shortest video (or ``max_frames``); no JPEG is written and
        at most ``chunk_frames`` decoded frames are held at once."""
        flip_set = set(camera_ids_to_flip)
        reg: dict = {}
        pts, conf = [], []
        for cam in range(num_cameras):
            path = os.path.join(folder, f"camera_{cam}.mp4")

            def chunks(path=path, cam=cam):
                frames = []
                with contextlib.closing(_video_frames(path)) as stream:
                    for n, frame in enumerate(stream, 1):
                        frames.append(frame)
                        if len(frames) >= chunk_frames:
                            yield self._video_chunk(frames, cam, cam in flip_set)
                            frames = []
                        if max_frames and n >= max_frames:
                            break
                if frames:
                    yield self._video_chunk(frames, cam, cam in flip_set)

            p, c = self.infer_chunks(chunks(), batch_size, registration=reg)
            pts.append(p)
            conf.append(c)
        T = min(p.shape[0] for p in pts)
        return (np.stack([p[:T] for p in pts]).astype(np.float64),
                np.stack([c[:T] for c in conf]).astype(np.float64))

    @staticmethod
    def _video_chunk(frames, cam: int, flip: bool):
        return np.stack(frames), np.full(len(frames), cam), np.full(len(frames), flip)
