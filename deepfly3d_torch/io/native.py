"""ctypes bindings for the native ingest runtime (``native/ingest.cpp``).

A jax-free copy of ``deepfly3d_tpu/io/native.py`` with the same C ABI: a
multithreaded libjpeg batch decoder and an in-process libav streaming video
decoder in ``native/libdf3d_ingest.so``.  The prebuilt library links the
libjpeg and ffmpeg libraries of the machine it was built on (``make -C
native``); where it does not load, ``available()`` is False, ``load_error``
says why, and the callers fall back to OpenCV, in the same order as the JAX
package.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libdf3d_ingest.so",
)
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu")
_HEADERS = ("jpeglib.h", "libavcodec/avcodec.h", "libavformat/avformat.h",
            "libswscale/swscale.h")

_lib = None
_tried = False
load_error: Optional[str] = None     # why the library is not available


def headers_found() -> dict:
    """{header: True/False}: the libjpeg and libav headers ``make -C native`` needs."""
    return {h: any(os.path.exists(os.path.join(d, h)) for d in _INCLUDE_DIRS)
            for h in _HEADERS}


def _bind(lib):
    lib.df3d_decode_jpeg_batch.restype = ctypes.c_int
    lib.df3d_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.df3d_video_open.restype = ctypes.c_void_p
    lib.df3d_video_open.argtypes = [ctypes.c_char_p]
    lib.df3d_video_width.restype = ctypes.c_int
    lib.df3d_video_width.argtypes = [ctypes.c_void_p]
    lib.df3d_video_height.restype = ctypes.c_int
    lib.df3d_video_height.argtypes = [ctypes.c_void_p]
    lib.df3d_video_fps.restype = ctypes.c_double
    lib.df3d_video_fps.argtypes = [ctypes.c_void_p]
    lib.df3d_video_read.restype = ctypes.c_int
    lib.df3d_video_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.df3d_video_close.restype = None
    lib.df3d_video_close.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    """The bound library, or None; tried once per process."""
    global _lib, _tried, load_error
    if not _tried:
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except OSError as e:
            load_error = str(e).splitlines()[0]
    return _lib


def available() -> bool:
    return _load() is not None


def decode_jpeg_batch(
    paths: Sequence[str], height: int, width: int, num_threads: int = 16
) -> np.ndarray:
    """Decode JPEGs into one contiguous (N, H, W, 3) uint8 RGB buffer."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest library not available ({load_error})")
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.df3d_decode_jpeg_batch(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height,
        width,
        num_threads,
    )
    if failures:
        raise IOError(f"native JPEG decode failed for {failures}/{n} files")
    return out


class VideoReader:
    """Streaming in-process video decode (RGB uint8 frames)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ingest library not available ({load_error})")
        self._lib = lib
        self._handle = lib.df3d_video_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open video: {path}")
        self.width = lib.df3d_video_width(self._handle)
        self.height = lib.df3d_video_height(self._handle)
        self.fps = lib.df3d_video_fps(self._handle)

    def read(self) -> Optional[np.ndarray]:
        frame = np.empty((self.height, self.width, 3), dtype=np.uint8)
        ret = self._lib.df3d_video_read(
            self._handle, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if ret == 1:
            return frame
        if ret == 0:
            return None
        raise IOError(f"video decode error ({ret})")

    def __iter__(self):
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self):
        if self._handle:
            self._lib.df3d_video_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
