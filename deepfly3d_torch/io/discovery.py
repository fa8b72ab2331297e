"""Image/video discovery and naming conventions (a copy of ``deepfly3d_tpu/io/discovery.py``).

Implements the ``camera_{c}_img_{i}.jpg`` layout contract (reference
df3d/os_util.py) and video-to-frame expansion.  The reference shells out to
ffmpeg/ffprobe subprocesses per video (reference df3d/core.py:416-459); here
decode goes through OpenCV's in-process demuxer (no subprocess spawn, works
without an ffmpeg binary) with an ffmpeg-subprocess fallback when available.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from deepfly3d_torch import logger

_IMG_RE = re.compile(r"camera_(\d+)_img_(\d+)")
_VID_RE = re.compile(r"camera_(\d+)")


def construct_image_name(cam_id: int, img_id: int, pad: bool = True) -> str:
    if pad:
        return f"camera_{cam_id}_img_{img_id:06d}"
    return f"camera_{cam_id}_img_{img_id}"


def parse_img_name(name: str):
    m = _IMG_RE.match(name.replace(".jpg", ""))
    if m is None:
        raise ValueError(f"Not an image name: {name}")
    return int(m[1]), int(m[2])


def parse_vid_name(name: str) -> int:
    m = _VID_RE.match(name.replace(".mp4", ""))
    if m is None:
        raise ValueError(f"Not a video name: {name}")
    return int(m[1])


def image_exists(path: str, img_id: int, num_cameras: int = 7) -> bool:
    for cid in range(num_cameras):
        if os.path.isfile(
            os.path.join(path, construct_image_name(cid, img_id, pad=False) + ".jpg")
        ):
            return True
    return os.path.isfile(
        os.path.join(path, construct_image_name(0, img_id, pad=True) + ".jpg")
    )


def get_max_img_id(path: str, num_cameras: int = 7) -> int:
    """Largest img_id present, via binary search on file existence.

    Same contract as reference df3d/os_util.py:7-23 (search space 0..100000,
    raises FileNotFoundError when no image exists).
    """
    lo, hi = 0, 100000
    cur = (lo + hi) // 2
    while hi - lo > 1:
        if image_exists(path, cur, num_cameras):
            lo = cur
        else:
            hi = cur
        cur = (lo + hi) // 2
    if not image_exists(path, cur, num_cameras):
        raise FileNotFoundError(f"No image found in {path}.")
    return cur


def image_path_template(folder: str) -> str:
    return os.path.join(folder, "camera_{cam_id}_img_{img_id}.jpg")


def list_videos(folder: str) -> List[str]:
    return sorted(glob.glob(os.path.join(folder, "camera_?.mp4")))


# ------------------------------------------------------------------ videos


def probe_fps(folder: str) -> Optional[float]:
    """Average frame rate of the recording's videos, or None.

    Mirrors the semantics of reference df3d/core.py:416-444 (first video wins;
    warn when rates differ; None when unreadable) without spawning ffprobe.
    """
    rates = []
    for vid in list_videos(folder):
        rate = _probe_fps_one(vid)
        if rate is None:
            logger.warning(f"Could not probe fps for: {vid}")
            break
        rates.append(rate)
    if not rates:
        return None
    if any(r != rates[0] for r in rates):
        logger.warning(
            f"Framerates of input videos differ, using the first one: {rates}"
        )
    return rates[0]


def _probe_fps_one(vid: str) -> Optional[float]:
    if shutil.which("ffprobe"):
        cmd = [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=avg_frame_rate", "-of",
            "default=noprint_wrappers=1:nokey=1", vid,
        ]
        try:
            out = subprocess.check_output(cmd, text=True).strip()
            if "/" in out:
                num, den = map(int, out.split("/"))
                return num / den if den else None
            return float(out)
        except Exception:
            return None
    try:
        import cv2

        cap = cv2.VideoCapture(vid)
        if not cap.isOpened():
            return None
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
        return fps if fps > 0 else None
    except Exception:
        return None


def video_frame_count(folder: str) -> int:
    """Minimum frame count across the folder's camera videos (0 if none).

    The streaming pipeline's analog of ``get_max_img_id``+1: with no JPEGs
    on disk the recording length comes from the demuxers directly
    (replaces the reference's expand-then-binary-search flow,
    reference core.py:446-459 + os_util.py:7-23).
    """
    import cv2

    counts = []
    for vid in list_videos(folder):
        cap = cv2.VideoCapture(vid)
        try:
            if not cap.isOpened():
                continue
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()
        if n > 0:
            counts.append(n)
    return min(counts) if counts else 0


def read_video_frame(vid: str, img_id: int) -> np.ndarray:
    """RGB uint8 frame ``img_id`` of a video (for plotting/GUI in
    streaming mode — bulk inference uses the sequential decoders).

    CAP_PROP_POS_FRAMES seeks are keyframe-inaccurate for some
    codec/container combinations under OpenCV, which would silently
    misalign the displayed image with the sequential decoder's frame
    numbering (the 2D overlays would be drawn on a neighbouring frame).
    The seek is therefore VERIFIED via the position readback and falls
    back to sequential decoding when the demuxer cannot prove it landed
    on the requested index.
    """
    import cv2

    cap = cv2.VideoCapture(vid)
    try:
        cap.set(cv2.CAP_PROP_POS_FRAMES, img_id)
        # readback: after a trusted seek the next grab is exactly img_id
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != img_id:
            cap.release()
            cap = cv2.VideoCapture(vid)  # sequential decode from 0
            for _ in range(img_id):
                if not cap.grab():
                    raise IOError(
                        f"Cannot reach frame {img_id} of {vid} sequentially"
                    )
        ok, frame = cap.read()
        if not ok:
            raise IOError(f"Cannot read frame {img_id} from {vid}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def expand_videos(folder: str, jpeg_quality: int = 94) -> None:
    """Expand each camera_{c}.mp4 into camera_{c}_img_{i}.jpg frames.

    Idempotent: skips a camera whose img_0 already exists (same resume
    behavior as reference df3d/core.py:446-459).  Prefers an ffmpeg binary
    (``-qscale:v 2``) for bit-parity with the reference flow, otherwise
    decodes in-process with OpenCV.
    """
    for vid in list_videos(folder):
        cam_id = parse_vid_name(os.path.basename(vid))
        if os.path.exists(
            os.path.join(folder, f"camera_{cam_id}_img_0.jpg")
        ) or os.path.exists(os.path.join(folder, f"camera_{cam_id}_img_000000.jpg")):
            continue
        if shutil.which("ffmpeg"):
            cmd = (
                f"ffmpeg -nostats -loglevel error -i {vid} -qscale:v 2 "
                f"-start_number 0 {folder}/camera_{cam_id}_img_%d.jpg < /dev/null"
            )
            subprocess.call(cmd, shell=True)
        else:
            _expand_video_cv2(vid, folder, cam_id, jpeg_quality)


def _expand_video_cv2(vid: str, folder: str, cam_id: int, jpeg_quality: int) -> None:
    import cv2

    cap = cv2.VideoCapture(vid)
    img_id = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out = os.path.join(folder, f"camera_{cam_id}_img_{img_id}.jpg")
        cv2.imwrite(out, frame, [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        img_id += 1
    cap.release()
    logger.debug(f"Expanded {vid} into {img_id} frames")


def delete_images(folder: str) -> None:
    """Remove expanded frames for cameras that still have their .mp4.

    Same safety rule as reference df3d/core.py:461-475: only delete images
    whose source video exists.
    """
    for vid in glob.glob(os.path.join(folder, "camera_[0-9].mp4")):
        cam_id = parse_vid_name(os.path.basename(vid))
        logger.debug(f"Deleting images for camera {cam_id}.")
        for img in glob.glob(os.path.join(folder, f"camera_{cam_id}_img_*.jpg")):
            os.remove(img)


def read_image(path: str) -> np.ndarray:
    """RGB uint8 image."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
