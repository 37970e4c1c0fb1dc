"""ctypes binding of the threaded host frame gather (csrc/gather.cpp).

The library is compiled from the port's own source with the host C++
compiler at first use, into the package's _build/ directory (listed in
.gitignore), under a file name that carries a digest of the source and
the flags, as ops/_build.py names the kernels' libraries. A failed build
raises with the compiler's output: nothing falls back to numpy on its
own. numpy fancy indexing stays the plain version (gather_frames_reference)
and the path for a store that is not float32 or not C-contiguous.

The call goes through ctypes.CDLL, which releases the GIL for its length,
so a gather in the prefetch thread overlaps the train step's Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from multimodal_outage_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "gather.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH to build "
                           f"{SOURCE.name}")
    return cxx


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return build_dir / f"gather-{digest[:12]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/gather.cpp unless its library exists; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    target = library_path(build_dir)
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees a partial file
    return target


def load_library() -> ctypes.CDLL:
    """The loaded gather library, built first if needed (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.gather_f32.restype = ctypes.c_int
            lib.gather_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def default_threads() -> int:
    """The gather's thread count: the host's cores, clamped to [2, 8]."""
    return max(2, min(8, os.cpu_count() or 2))


def gather_frames_reference(frames: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The plain version: numpy fancy indexing, as float32."""
    return np.asarray(frames[np.asarray(indices, dtype=np.int64)], dtype=np.float32)


def gather_frames(
    frames: np.ndarray,
    indices: np.ndarray,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """frames [D, ...], indices [K] → contiguous float32 [K, ...].

    A float32 C-contiguous store (a memmap included) goes through the
    native gather, into `out` when given (a float32 C-contiguous array of
    shape [K, ...], e.g. a view of a pinned buffer); any other store
    through numpy fancy indexing, copied into `out` when given. Positions
    outside [0, D) raise IndexError. The copy runs on default_threads()
    threads."""
    indices = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    shape = (indices.shape[0],) + tuple(frames.shape[1:])
    if out is not None and (
        out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]
        or not out.flags["WRITEABLE"]
    ):
        raise ValueError(f"out must be a writable C-contiguous float32 array of shape "
                         f"{shape}, got {out.shape} {out.dtype}")
    if indices.size and (indices.min() < 0 or indices.max() >= frames.shape[0]):
        raise IndexError(f"frame positions must lie in [0, {frames.shape[0]}), got "
                         f"[{indices.min()}, {indices.max()}]")
    if frames.dtype != np.float32 or not frames.flags["C_CONTIGUOUS"]:
        got = gather_frames_reference(frames, indices)
        if out is None:
            return got
        out[...] = got
        return out
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    if indices.size == 0:
        return out
    rc = load_library().gather_f32(
        frames.ctypes.data, indices.ctypes.data, out.ctypes.data,
        indices.shape[0], int(np.prod(frames.shape[1:])),
        default_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"gather_f32 returned {rc}: a worker thread could not start")
    return out
