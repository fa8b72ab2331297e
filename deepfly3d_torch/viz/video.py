"""Result videos (cv2 VideoWriter, mp4v): a copy of ``deepfly3d_tpu/viz/video.py``.

Layouts of reference df3d/video.py: the 2D video is a 2x3 grid of camera
overlays (rows: cameras 0-2 and 4-6, the fly rig's two sides), the 3D video
adds a third row of 3D views; frames are resized to a fixed total width.
The 3D row is drawn by ``viz/raster3d.py`` by default; ``renderer=
"matplotlib"`` draws reference-look figures, fanned out over a process pool
of one worker per CPU core when there is more than one.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Iterable, Optional

import numpy as np

from deepfly3d_torch import logger
from deepfly3d_torch.viz.plot3d import IMG3D_ASPECT, IMG3D_DPI, render_frame_3d
from deepfly3d_torch.viz.raster3d import render_frame_3d_fast

VIDEO_WIDTH = 5000
DEFAULT_FPS = 30
IMG2D_ASPECT = (2, 1)


def make_pose2d_video(
    plot_2d: Callable,
    num_images: int,
    input_folder: str,
    output_folder: str,
    fps: Optional[float] = DEFAULT_FPS,
    smooth: bool = False,
):
    """2x3 grid video of 2D overlays (reference video.py:21-48).

    ``smooth`` defaults to False to match the reference's shipped videos:
    its video.py:65-66 passes smooth=True but reference core.py:298-319
    ignores the flag and always draws the raw stored points — the golden
    video is rendered from RAW points.  Pass smooth=True here for the
    (working) adaptive-smoothing overlay the reference intended.
    """

    def frames():
        for img_id in range(num_images):
            row1 = np.hstack(
                [plot_2d(c, img_id, smooth=smooth) for c in (0, 1, 2)]
            )
            row2 = np.hstack(
                [plot_2d(c, img_id, smooth=smooth) for c in (4, 5, 6)]
            )
            yield np.vstack([row1, row2])

    name = "video_pose2d_" + input_folder.replace("/", "_") + ".mp4"
    _write_video(os.path.join(output_folder, name), frames(), fps)


def _render_3d_serial(points3d, skeleton, num_images, renderer):
    """Per-frame 3D-row generator: [(img (h,w,3) for cams 4,5,6)]."""
    render = (
        render_frame_3d_fast if renderer == "raster" else render_frame_3d
    )
    for img_id in range(num_images):
        yield [render(points3d[img_id], skeleton, cam_id=c) for c in (4, 5, 6)]


def _mpl_render_job(args):
    points3d_frame, skeleton, cam_id = args
    return render_frame_3d(points3d_frame, skeleton, cam_id=cam_id)


def _render_3d_pooled(points3d, skeleton, num_images, workers):
    """matplotlib 3D rows rendered by a process pool, one job per
    (frame, camera), results re-assembled in frame order with a bounded
    pipeline (window of pending jobs, so hour-long recordings never
    materialize every rendered frame in RAM)."""
    import concurrent.futures as futures
    import itertools
    import multiprocessing
    from collections import deque

    jobs = iter(
        (points3d[img_id], skeleton, c)
        for img_id in range(num_images)
        for c in (4, 5, 6)
    )
    # spawned workers: the caller may hold threads and a CUDA context, which a
    # forked child would inherit
    spawn = multiprocessing.get_context("spawn")
    with futures.ProcessPoolExecutor(max_workers=workers, mp_context=spawn) as pool:
        # manual windowed submission: Executor.map would submit every job
        # eagerly and buffer all completed frames ahead of the consumer,
        # which is exactly the unbounded-memory failure the window avoids
        window = max(4 * workers, 8) * 3
        pending = deque(
            pool.submit(_mpl_render_job, args)
            for args in itertools.islice(jobs, window)
        )
        row = []
        while pending:
            img = pending.popleft().result()
            nxt = next(jobs, None)
            if nxt is not None:
                pending.append(pool.submit(_mpl_render_job, nxt))
            row.append(img)
            if len(row) == 3:
                yield row
                row = []


def make_pose3d_video(
    points3d: np.ndarray,
    plot_2d: Callable,
    num_images: int,
    input_folder: str,
    output_folder: str,
    fps: Optional[float] = DEFAULT_FPS,
    skeleton=None,
    renderer: str = "raster",
    smooth: bool = False,
):
    """2D grid + 3D row video (reference video.py:51-78).

    ``renderer``: "raster" (default — direct cv2 projection,
    viz/raster3d.py) or "matplotlib" (reference-look figures; pooled
    across processes when the host has more than one core).
    ``smooth``: False matches the reference's shipped golden video (its
    smooth flag is dead — reference core.py:298-319 draws raw points);
    True enables the working adaptive 2D smoothing.
    """
    import cv2

    if skeleton is None:
        from deepfly3d_torch.skeletons import fly

        skeleton = fly.skeleton

    size_2d = (IMG2D_ASPECT[0] * IMG3D_DPI, IMG2D_ASPECT[1] * IMG3D_DPI)

    workers = os.cpu_count() or 1
    if renderer == "matplotlib" and workers > 1:
        rows3d = _render_3d_pooled(points3d, skeleton, num_images, workers)
    else:
        rows3d = _render_3d_serial(points3d, skeleton, num_images, renderer)

    def frames():
        for img_id, row3_imgs in zip(range(num_images), rows3d):
            row1 = np.hstack(
                [
                    cv2.resize(plot_2d(c, img_id, smooth=smooth), size_2d)
                    for c in (0, 1, 2)
                ]
            )
            row2 = np.hstack(
                [
                    cv2.resize(plot_2d(c, img_id, smooth=smooth), size_2d)
                    for c in (4, 5, 6)
                ]
            )
            row3 = np.hstack(row3_imgs)
            if row3.shape[1] != row1.shape[1]:
                row3 = cv2.resize(row3, (row1.shape[1], row3.shape[0]))
            yield np.vstack([row1, row2, row3])

    name = "video_pose3d_" + input_folder.replace("/", "_") + ".mp4"
    _write_video(os.path.join(output_folder, name), frames(), fps)


def _write_video(
    path: str, frames: Iterable[np.ndarray], fps: Optional[float]
):
    """Write RGB frames, resized to VIDEO_WIDTH, as mp4v (reference video.py:81-108)."""
    import cv2

    if fps is None:
        fps = DEFAULT_FPS
    first = next(iter(frames))
    frames = itertools.chain([first], frames)
    h, w = first.shape[:2]
    scale = VIDEO_WIDTH / w
    out_size = (int(w * scale), int(h * scale))
    logger.debug(f"Saving video to: {path} size {out_size}")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, out_size)
    try:
        for frame in frames:
            resized = cv2.resize(frame, out_size)
            writer.write(cv2.cvtColor(resized, cv2.COLOR_BGR2RGB))
    finally:
        writer.release()
    logger.info(f"Video created at {path}")
