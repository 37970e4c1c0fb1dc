"""Build and load the hand-written CUDA kernels under csrc/.

Each csrc/<name>.cu has a plain C interface and is compiled by nvcc into
its own shared library, at first use, into the package's _build/
directory (listed in .gitignore), then loaded with ctypes. Pointers and
the stream cross as c_void_p. The library file name carries a digest of
the source, the shared headers (csrc/*.cuh) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing
is taken from outside the repo but the CUDA toolkit itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("double_conv", "gwnet_stack", "max_pool", "gwnet_layer", "dcrnn_stack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# loaded libraries, one per kernel source, for the life of the process
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are compiled on the machine with the card"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, Tuple[float, str]]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: (seconds, ptxas report)};
    a cached library reports 0 seconds. Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Tuple[float, str]] = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = (0.0, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees a partial file
        out[name] = (time.perf_counter() - t0, stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
