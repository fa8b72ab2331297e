"""One build of the port's CUDA kernels, at first use.

Each source under ``ops/csrc`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, and loaded with ``ctypes``.  The
sources include no PyTorch header, so a build takes seconds; all sources
are compiled at once, one ``nvcc`` process each.  Outputs go to
``deepfly3d_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and flags, so an edited source is rebuilt and
an unchanged one is reused.  This module imports nothing from the CUDA
toolkit at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = ("bottleneck", "bottleneck_128", "bottleneck_bf16", "bottleneck_general",
           "upsample_add", "decode", "preprocess", "stem_conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: compiler output}`` for the sources compiled in this
    call (``-Xptxas -v`` prints registers, shared memory and spills).
    Raises RuntimeError with the compiler's output if one fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in SOURCES:
        target = _target(name)
        if os.path.exists(target):
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)     # atomic: concurrent builders agree
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not os.path.exists(target):
            build()
        lib = ctypes.CDLL(target)
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (0 is success)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
